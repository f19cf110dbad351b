"""Host side of kernel D (the row-0 conv's weight gradient): the wgmma
kernel's (csrc/conv3x3_wgrad_sm90.cu) run plan and partial layout, emulated
in plain torch and held to the plain version and to the Pallas kernel it
replaces (Mosaic interpreter on the CPU); the float32 body's plan; the
wrapper's choice of entry; and the profile family of the new kernel."""

import subprocess

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.ops.packed_row import _dk_from_db
from tactile_gan_tpu.ops.pallas.conv3x3 import conv3x3_packed_wgrad, pack_w

from tactile_gan_torch.ops.kernels import build
from tactile_gan_torch.ops.kernels import conv3x3_wgrad as kd
from tactile_gan_torch.utils import profiling

torch.set_num_threads(2)


def _case(n, h, w, cin, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    g = rng.normal(size=(n, h, w, co)).astype(np.float32)
    return x, g


def _emulate(x, g, cd, per=None):
    """The wgmma kernel's sum in plain torch: block (ci tile, chunk) adds,
    for each (strip, output row) of its run (strip-major, crossing strips),
    the 9 taps of 64 output columns as x^T g over the 64 pixels, with x
    zero outside the image and past its width; its partial
    [chunk][9][Cin][Co] is summed over the chunks in order, then laid out
    OIHW. ``per``: the run length, by default the launch plan's."""
    n, h, w, cin = x.shape
    co = g.shape[-1]
    cols = kd.SM90_COLS
    strips_w = -(-w // cols)
    rows = n * strips_w * h
    if per is None:
        per, chunks = kd.launch_plan(n, h, w, cin)
    else:
        chunks = -(-rows // per)
    xp = torch.zeros(n, h + 2, strips_w * cols + 2, cin)
    xp[:, 1:h + 1, 1:w + 1] = x.to(cd).float()
    gp = torch.zeros(n, h, strips_w * cols, co)
    gp[:, :, :w] = g.to(cd).float()
    part = torch.zeros(chunks, 9, cin, co)
    for c0 in range(0, cin, kd.SM90_CI):
        cs = slice(c0, min(cin, c0 + kd.SM90_CI))
        for c in range(chunks):
            for pos in range(c * per, min(rows, (c + 1) * per)):
                strip, r = divmod(pos, h)
                img, j = divmod(strip, strips_w)
                w0 = j * cols
                gg = gp[img, r, w0:w0 + cols]
                for dh in range(3):
                    for dw in range(3):
                        xx = xp[img, r + dh, w0 + dw:w0 + dw + cols, cs]
                        part[c, 3 * dh + dw, cs] += xx.T @ gg
    dk = part[0].clone()
    for c in range(1, chunks):
        dk += part[c]
    return dk.permute(2, 1, 0).reshape(co, cin, 3, 3)


@pytest.mark.parametrize("cin", [24, 64, 136])
@pytest.mark.parametrize("co", [16, 64])
@pytest.mark.parametrize("per", [None, 3])
def test_partial_layout_sums_to_the_plain_version(cin, co, per):
    """Per chunk, per strip run, then the ordered sum: the plain version's
    dk, with the launch plan's runs and with runs of 3 rows that cross
    strips (5 rows each) and a partial strip (W 70)."""
    x, g = _case(2, 5, 70, cin, co, cin + co)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    got = _emulate(tx, tg, torch.bfloat16, per)
    want = kd.conv3x3_wgrad_plain(tx, tg, compute_dtype=torch.bfloat16)
    # Same rounded operands, exact products; float32 sums of up to 700
    # terms in another order, relative to the largest entry.
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=1e-5)


def test_partial_layout_matches_the_pallas_wgrad():
    """The emulated wgmma sum against the Pallas kernel it replaces, folded
    by _dk_from_db, on the same bf16-rounded operands."""
    n, h, w, c, co = 2, 8, 12, 16, 16
    x, g = _case(n, h, w, c, co, 41)
    dbm, dbl = conv3x3_packed_wgrad(pack_w(jnp.asarray(x)),
                                    pack_w(jnp.asarray(g)), h=h,
                                    interpret=True,
                                    compute_dtype=jnp.bfloat16, block_h=4)
    want = np.asarray(_dk_from_db(dbm, dbl, c, co)).transpose(3, 2, 0, 1)
    got = _emulate(torch.from_numpy(x), torch.from_numpy(g), torch.bfloat16,
                   per=3)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                               rtol=1e-5)


@pytest.mark.parametrize("cd,want", [(torch.bfloat16, kd.SM90_ENTRY),
                                     (torch.float32, kd.F32_ENTRY)])
def test_wrapper_entry_by_compute_dtype(cd, want):
    """bf16 operands (either input dtype) go to the wgmma kernel, float32
    operands to the CUDA-core body; the reduce lives beside the latter."""
    assert kd.partial_entry(cd) == want
    assert kd._SOURCES == {kd.SM90_ENTRY: "conv3x3_wgrad_sm90",
                           kd.F32_ENTRY: "conv3x3_wgrad"}


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing(cd):
    x, g = _case(1, 4, 6, 12, 8, 3)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    before = kd.conv3x3_wgrad.launches
    got = kd.conv3x3_wgrad(tx, tg, compute_dtype=cd)
    assert kd.conv3x3_wgrad.launches == before
    assert torch.equal(got, kd.conv3x3_wgrad_plain(tx, tg, compute_dtype=cd))


def test_wrapper_refuses_other_devices_and_compute_dtypes():
    x = torch.zeros(1, 2, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kd.conv3x3_wgrad(x, x)
    with pytest.raises(ValueError, match="unsupported compute dtype"):
        kd.conv3x3_wgrad(torch.zeros(1, 2, 2, 8), torch.zeros(1, 2, 2, 8),
                         compute_dtype=torch.float16)


@pytest.mark.parametrize("n,h,w,cin", [(4, 256, 256, 64), (4, 256, 256, 384),
                                       (2, 37, 53, 24), (1, 9, 17, 8)])
def test_f32_launch_plan_covers_every_tile(n, h, w, cin):
    """The float32 body's split of the 8x32 tiles, two blocks an SM."""
    per, chunks = kd.f32_launch_plan(n, h, w, cin)
    tiles = n * -(-h // 8) * -(-w // 32)
    assert per * chunks >= tiles > per * (chunks - 1)
    if tiles >= 264:
        assert 132 <= chunks * -(-cin // 32) <= 264


def test_profile_counts_the_wgmma_wgrad_kernel_as_kernel_d():
    """Its name holds "sm90_", a library substring; the own families are
    matched first."""
    for t in ("float", "__nv_bfloat16"):
        name = (f"void (anonymous namespace)::conv3x3_wgrad_sm90_kernel<{t}>"
                "(const float *, ...)")
        assert profiling.kernel_family(name) == "kernel_d"
    assert profiling.kernel_family(
        "void (anonymous namespace)::wgrad_reduce_kernel(...)") == "kernel_d"


def test_wgmma_wgrad_builds_with_the_common_flags(tmp_path, monkeypatch):
    """Both wgmma sources keep their proxy fence out of line, so both build
    with the common flags (no -Xptxas -O1): the nvcc command that build()
    runs is NVCC_FLAGS, the output and the source."""
    cmds = []

    def fake_run(cmd, **kwargs):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    for name in ("conv3x3_wgrad_sm90", "conv3x3_fwd_sm90"):
        out = build.build(name)
        assert out.parent == tmp_path and out.exists()
        cmd = cmds[-1]
        assert cmd[0] == "nvcc" and tuple(cmd[1:-3]) == build.NVCC_FLAGS
        assert cmd[-3] == "-o" and cmd[-1] == str(build.CSRC / f"{name}.cu")
    assert "-O1" not in build.NVCC_FLAGS
