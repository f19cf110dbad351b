"""Port kernel E (conv3x3_p1, conv3x3_p1_h) and the conv probe entry point:
the plain PyTorch version against the Pallas functions (Mosaic interpreter
on the CPU) on the same numpy inputs, the port's wider domain, its errors,
its weight relayout and ``cli.probe_conv`` on the CPU. The CUDA kernel itself
is held against the plain version on the card by chip_smoke.py."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.ops.pallas.conv3x3 import conv3x3_p1 as pallas_p1
from tactile_gan_tpu.ops.pallas.conv3x3 import conv3x3_p1_h as pallas_p1_h

from tactile_gan_torch.cli import probe_conv
from tactile_gan_torch.ops.kernels import conv3x3 as kb

torch.set_num_threads(2)

PALLAS = {"conv3x3_p1": pallas_p1, "conv3x3_p1_h": pallas_p1_h}
NAMES = sorted(PALLAS)
# Both sides round the same operands to compute_dtype and sum the same
# float32 products (at most 9 * 64 = 576 of them) in another order: the
# difference is a few float32 ulps of the largest partial sum, measured at
# <= 2.4e-6 of the output's max at these shapes. Held to 1e-5 of the max.
REL_TOL = 1e-5


def _inputs(n, h, w, c, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, co)) * 0.1).astype(np.float32)  # HWIO
    return x, k


def _bf16_round(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _assert_rel_close(got: np.ndarray, want: np.ndarray, tol: float):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("n,h,w,c,co", [(2, 8, 16, 3, 5), (1, 16, 16, 64, 64),
                                        (2, 12, 8, 32, 64),
                                        (1, 8, 16, 64, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", NAMES)
def test_p1_matches_pallas(name, n, h, w, c, co, dtype, compute):
    x, k = _inputs(n, h, w, c, co, 3 + c)
    if dtype == "bfloat16":
        x = _bf16_round(x)
    want = np.asarray(PALLAS[name](
        jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(k), interpret=True,
        compute_dtype=getattr(jnp, compute)))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    cd = getattr(torch, compute)
    before = getattr(kb, name).launches
    got = getattr(kb, name)(tx, torch.from_numpy(k), compute_dtype=cd)
    assert getattr(kb, name).launches == before  # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == (n, h, w, co)
    assert torch.equal(got, kb.conv3x3_p1_plain(tx, torch.from_numpy(k),
                                                compute_dtype=cd))
    _assert_rel_close(got.numpy(), want, REL_TOL)


def _reference(x: torch.Tensor, k: torch.Tensor, cd) -> np.ndarray:
    """float64 3x3/s1/p1 conv of the operands rounded to cd, tap by tap."""
    xr = x.to(cd).double().numpy()
    kr = k.to(cd).double().numpy()
    n, h, w, _ = xr.shape
    xp = np.pad(xr, ((0, 0), (1, 1), (1, 1), (0, 0)))
    y = np.zeros((n, h, w, kr.shape[3]))
    for dh in range(3):
        for dw in range(3):
            y += xp[:, dh:dh + h, dw:dw + w, :] @ kr[dh, dw]
    return y


@pytest.mark.parametrize("n,h,w,c,co", [(1, 7, 9, 3, 5), (2, 5, 6, 13, 24),
                                        (1, 8, 11, 8, 16), (3, 1, 1, 1, 1)])
@pytest.mark.parametrize("name", NAMES)
def test_p1_takes_odd_sizes(name, n, h, w, c, co):
    """Odd H or W, where the Pallas functions raise (conv3x3_p1 needs an even
    W, conv3x3_p1_h an even H): the port computes the same function there,
    held to a float64 conv of the same rounded operands."""
    x, k = _inputs(n, h, w, c, co, 7 + h)
    tx, tk = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(k)
    for cd in (torch.bfloat16, torch.float32):
        got = getattr(kb, name)(tx, tk, compute_dtype=cd)
        assert got.dtype == torch.float32 and got.shape == (n, h, w, co)
        assert torch.equal(got, kb.conv3x3_p1_plain(tx, tk, compute_dtype=cd))
        _assert_rel_close(got.double().numpy(), _reference(tx, tk, cd),
                          REL_TOL)


def _bad_calls():
    x = torch.zeros(1, 4, 6, 3)
    k = torch.zeros(3, 3, 3, 5)
    yield "compute float16", ValueError, (x, k), {
        "compute_dtype": torch.float16}
    yield "k Cin mismatch", ValueError, (x, torch.zeros(3, 3, 4, 5)), {}
    yield "k 2x3 taps", ValueError, (x, torch.zeros(3, 2, 3, 5)), {}
    yield "k 3-d", ValueError, (x, torch.zeros(3, 3, 3)), {}
    yield "x 3-d", ValueError, (torch.zeros(4, 6, 3), k), {}
    yield "x float16", ValueError, (x.half(), k), {}
    yield "x empty", ValueError, (torch.zeros(0, 4, 6, 3), k), {}
    yield "meta device", ValueError, (x.to("meta"), k.to("meta")), {}
    yield "x requires grad", RuntimeError, (x.clone().requires_grad_(), k), {}
    yield "k requires grad", RuntimeError, (
        x, torch.nn.Parameter(k.clone())), {}


@pytest.mark.parametrize("case", [c[0] for c in _bad_calls()])
@pytest.mark.parametrize("name", NAMES)
def test_p1_refuses(name, case):
    _, exc, args, kwargs = next(c for c in _bad_calls() if c[0] == case)
    with pytest.raises(exc):
        getattr(kb, name)(*args, **kwargs)


def test_p1_forward_only_runs_without_grad():
    x = torch.randn(1, 4, 6, 3, requires_grad=True)
    k = torch.nn.Parameter(torch.randn(3, 3, 3, 5))
    with pytest.raises(RuntimeError, match="forward only"):
        kb.conv3x3_p1(x, k)
    with torch.no_grad():
        y = kb.conv3x3_p1(x, k)
    assert y.grad_fn is None and not y.requires_grad


@pytest.mark.parametrize("c,co", [(3, 5), (13, 40), (64, 64), (24, 96)])
def test_p1_weight_relayout(c, co):
    k = torch.from_numpy(_inputs(1, 1, 1, c, co, c)[1])
    tile = kb.co_tile(co)
    co_rows = -(-co // tile) * tile
    bf = kb._kernel_weight(k, torch.bfloat16, "p1")
    assert bf.shape == (9, co_rows, -(-c // 16) * 16)
    f32 = kb._kernel_weight(k, torch.float32, "p1")
    assert f32.shape == (9, -(-c // 8) * 8, co_rows)
    for tap in range(9):
        np.testing.assert_array_equal(
            bf[tap, :co, :c].float().numpy(),
            k[tap // 3, tap % 3].T.to(torch.bfloat16).float().numpy())
        np.testing.assert_array_equal(f32[tap, :c, :co].numpy(),
                                      k[tap // 3, tap % 3].numpy())
    assert not bf[:, co:].any() and not bf[:, :, c:].any()
    assert not f32[:, c:].any() and not f32[:, :, co:].any()
    assert kb._kernel_weight(k, torch.bfloat16, "p1") is bf
    k.mul_(2)  # an in-place update rebuilds the entry
    again = kb._kernel_weight(k, torch.bfloat16, "p1")
    assert again is not bf
    torch.testing.assert_close(again.float(), 2 * bf.float())


def test_probe_conv_runs_on_cpu(capsys):
    res = probe_conv.main(["1", "8", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "backend: cpu"
    per_shape = 1 + len(probe_conv.FORMULATIONS)
    assert len(lines) == 1 + per_shape * len(probe_conv.SHAPES)
    for i, (cin, co) in enumerate(probe_conv.SHAPES):
        head = lines[1 + i * per_shape]
        assert head.startswith(f"cin={cin} co={co} (B1 8^2): kernel E rel err")
        for j, (label, _) in enumerate(probe_conv.FORMULATIONS):
            line = lines[2 + i * per_shape + j]
            assert line.startswith(f"  {label:<7}:") and "TFLOP/s" in line
    assert (res["device"], res["batch"], res["size"]) == ("cpu", 1, 8)
    for row in res["shapes"]:
        # The library conv rounds its output to bf16; E keeps float32.
        assert 0 < row["rel_err"] <= 2.0 ** -7
        for label, _ in probe_conv.FORMULATIONS:
            assert math.isfinite(row["ms"][label]) and row["ms"][label] > 0
            assert math.isfinite(row["tflops"][label])
    timed = probe_conv.WARMUP + probe_conv.ITERS["cpu"]
    n = len(probe_conv.SHAPES)
    assert res["calls"] == {"conv3x3_p1": n * (1 + timed),
                            "conv3x3_p1_h": n * timed, "conv3x3": n * timed}


def test_probe_conv_defaults_to_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_conv.main(["1", "8"])
    with pytest.raises(SystemExit):
        probe_conv.main(["4"])  # B without S


def test_ptxas_report_names_each_kernel():
    from tactile_gan_torch.ops.kernels import build

    mangled = "_ZN12_GLOBAL__N_119conv3x3_bf16_kernelIfLi64EEEvPKT_PK13__nv_bfloat16PS1_iiiiii"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
        f"ptxas info    : Function properties for {mangled}",
        "    40 bytes stack frame, 64 bytes spill stores, 48 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 40 bytes "
        "cumulative stack size",
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fooPf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 8 registers, 360 bytes cmem[0]"])
    report = build.ptxas_report(log)
    assert sorted(report.values()) == [
        "128 registers, 64 B spill stores, 48 B spill loads",
        "8 registers, 0 B spill stores, 0 B spill loads"]
    # Demangled where c++filt is installed.
    assert set(report) in ({"conv3x3_bf16_kernel<float, 64>", "foo"},
                           {mangled, "_Z3fooPf"})
