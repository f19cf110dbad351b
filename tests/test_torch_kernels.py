"""Port kernels A and B: their plain PyTorch versions against the Pallas
kernels (Mosaic interpreter on the CPU) and the JAX ops, on the same numpy
inputs. The CUDA kernels themselves are held against these plain versions on
the card by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.ops.conv import conv2d as jax_conv2d
from tactile_gan_tpu.ops.pallas.conv3x3 import conv3x3_packed, pack_w, unpack_w
from tactile_gan_tpu.ops.pallas.instance_norm import (
    instance_norm_act as pallas_instance_norm_act,
)

from tactile_gan_torch.ops.kernels import conv3x3 as kb
from tactile_gan_torch.ops.kernels import instance_norm as ka

torch.set_num_threads(2)

# Output compared after one bf16 rounding on each side: a flipped rounding
# is one bf16 ulp, at most 2^-7 of the value; 2^-6 leaves room for the
# ulp of the neighbouring binade.
BF16_TOL = dict(atol=1e-2, rtol=2.0 ** -6)


def _bf16_round(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


# ---------------------------------------------------------------------------
# Kernel A: instance norm + affine + act.
# ---------------------------------------------------------------------------

# Shapes that take each form of the Pallas kernel: lane-fold (N*C < 128 and
# divides it), batch-lane (N*C a multiple of 128), per-batch (N*C with no
# tile relation to 128), with and without the per-batch lane fold.
IN_SHAPES = {"lane_fold": (2, 8, 8, 16), "batch_lane": (2, 8, 8, 64),
             "per_batch": (3, 8, 8, 24), "per_batch_fold": (3, 8, 8, 64)}


def _in_inputs(shape, seed, affine):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    if not affine:
        return x, None, None
    return (x, (1 + 0.5 * rng.normal(size=(c,))).astype(np.float32),
            (0.5 * rng.normal(size=(c,))).astype(np.float32))


def _in_case(form, dtype, act, affine):
    x, s, o = _in_inputs(IN_SHAPES[form], 17, affine)
    if dtype == "bfloat16":
        x = _bf16_round(x)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = pallas_instance_norm_act(
        jx, None if s is None else jnp.asarray(s),
        None if o is None else jnp.asarray(o), act=act, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ka.instance_norm_act_plain(
        tx, None if s is None else torch.from_numpy(s),
        None if o is None else torch.from_numpy(o), act=act)
    assert got.dtype == tx.dtype  # output dtype follows the input
    # float32: the Pallas kernel's single-pass E[x^2]-m^2 against the plain
    # two-pass variance, |mean|/std about 1/3 here.
    tol = BF16_TOL if dtype == "bfloat16" else dict(atol=5e-5, rtol=1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("form", sorted(IN_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", None])
def test_instance_norm_plain_matches_pallas(form, dtype, act):
    _in_case(form, dtype, act, affine=True)


@pytest.mark.parametrize("form", sorted(IN_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_plain_matches_pallas_non_affine(form, dtype):
    _in_case(form, dtype, "relu", affine=False)


def test_instance_norm_wrapper_takes_plain_version_on_cpu():
    x, s, o = _in_inputs((2, 4, 4, 8), 3, True)
    args = (torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(o))
    before = ka.instance_norm_act.launches
    got = ka.instance_norm_act(*args, act="leaky_relu")
    want = ka.instance_norm_act_plain(*args, act="leaky_relu")
    assert torch.equal(got, want)
    assert ka.instance_norm_act.launches == before  # no kernel launched


def test_instance_norm_wrapper_refuses_other_devices_and_acts():
    with pytest.raises(ValueError):
        ka.instance_norm_act(torch.empty(1, 2, 2, 8, device="meta"))
    with pytest.raises(ValueError):
        ka.instance_norm_act(torch.zeros(1, 2, 2, 8), act="gelu")


@pytest.mark.parametrize("n,hw,c", [(1, 256 * 256, 64), (4, 128 * 128, 128),
                                    (1, 16 * 16, 1024), (2, 7 * 5, 24)])
def test_instance_norm_launch_plan_covers_every_pixel(n, hw, c):
    for dtype in (torch.float32, torch.bfloat16):
        for inputs in (1, 2):  # kernel A keeps x; kernel C x and g
            plan = ka.launch_plan(n, hw, c, dtype, inputs)
            # whole images a slab, no block without pixels, every pixel once
            assert (plan.bpi - 1) * plan.share < hw <= plan.bpi * plan.share
            assert plan.grid == plan.ips * plan.bpi <= 132
            assert plan.resident + plan.streamed == plan.share
            assert plan.smem <= ka.SMEM_MAX
            if hw >= 128 * 128:  # the large rows fill the card's 132 SMs
                assert plan.grid == 132


# ---------------------------------------------------------------------------
# Kernel B: 3x3/s1/p1 conv, NHWC, float32 accumulation.
# ---------------------------------------------------------------------------

def _conv_inputs(n, h, w, c, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, co)) * 0.1).astype(np.float32)  # HWIO
    return x, k


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("n,h,w,c,co", [(1, 16, 16, 64, 64),
                                        (2, 8, 12, 16, 16),
                                        (1, 8, 8, 8, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_conv3x3_plain_matches_pallas_packed(n, h, w, c, co, dtype, compute):
    x, k = _conv_inputs(n, h, w, c, co, 11)
    if dtype == "bfloat16":
        x = _bf16_round(x)
    xp = pack_w(jnp.asarray(x, jnp.dtype(dtype)))
    want = unpack_w(conv3x3_packed(xp, jnp.asarray(k), h=h, interpret=True,
                                   compute_dtype=jnp.dtype(compute)), h, co)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = kb.conv3x3_plain(tx, _oihw(k), compute_dtype=getattr(torch, compute))
    assert got.dtype == tx.dtype and got.shape == (n, h, w, co)
    # Same rounded operands and exact products; float32 sums of 9*C terms
    # in another order.
    tol = BF16_TOL if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("cin", [96, 192, 384])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_conv3x3_plain_matches_jax_conv_wide_input(cin, compute):
    """Cin > 64 (the concatenated node inputs) is beyond the Pallas kernel,
    so the reference is the JAX package's conv2d with the same policy."""
    x, k = _conv_inputs(1, 8, 8, cin, 64, cin)
    want = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(k), padding=1,
                                 compute_dtype=jnp.dtype(compute)))
    got = kb.conv3x3_plain(torch.from_numpy(x), _oihw(k),
                           compute_dtype=getattr(torch, compute)).numpy()
    if compute == "float32":
        # float32 sums of up to 3,456 terms in another order.
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        # The JAX conv rounds its bf16 output (2^-9 relative); the kernel
        # keeps the float32 accumulator.
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=2.0 ** -8)


def test_conv3x3_weight_relayout():
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(16, 24, 3, 3)).astype(np.float32))
    # bf16 compute: [9][Co][Cin_pad], Cin padded to 32 with zeros.
    wk = kb.relayout_weight(w, torch.bfloat16)
    assert wk.shape == (9, 16, 32) and wk.dtype == torch.bfloat16
    for tap in range(9):
        np.testing.assert_array_equal(
            wk[tap, :, :24].float().numpy(),
            w[:, :, tap // 3, tap % 3].to(torch.bfloat16).float().numpy())
    assert not wk[:, :, 24:].any()
    # float32 compute: [9][Cin][Co].
    wk = kb.relayout_weight(w, torch.float32)
    assert wk.shape == (9, 24, 16) and wk.dtype == torch.float32
    for tap in range(9):
        np.testing.assert_array_equal(wk[tap].numpy(),
                                      w[:, :, tap // 3, tap % 3].T.numpy())


def test_conv3x3_weight_relayout_is_kept_until_the_weight_changes():
    w = torch.nn.Parameter(torch.randn(16, 8, 3, 3))
    first = kb._kernel_weight(w, torch.bfloat16)
    assert kb._kernel_weight(w, torch.bfloat16) is first
    assert kb._kernel_weight(w, torch.float32).dtype == torch.float32
    with torch.no_grad():
        w.mul_(2)  # an in-place update (an optimizer step, load_state_dict)
    again = kb._kernel_weight(w, torch.bfloat16)
    assert again is not first
    torch.testing.assert_close(again.float(), 2 * first.float())
    w.data = torch.randn(16, 8, 3, 3)  # new storage, as Module.to gives
    torch.testing.assert_close(kb._kernel_weight(w, torch.bfloat16),
                               kb.relayout_weight(w.detach(), torch.bfloat16))


def test_conv3x3_wrapper_takes_plain_version_on_cpu():
    x, k = _conv_inputs(1, 6, 10, 8, 16, 2)
    before = kb.conv3x3.launches
    got = kb.conv3x3(torch.from_numpy(x), _oihw(k))
    assert torch.equal(got, kb.conv3x3_plain(torch.from_numpy(x), _oihw(k)))
    assert kb.conv3x3.launches == before
    with pytest.raises(ValueError):
        kb.conv3x3(torch.empty(1, 4, 4, 8, device="meta"),
                   torch.empty(16, 8, 3, 3, device="meta"))
    with pytest.raises(ValueError):
        kb.conv3x3(torch.from_numpy(x), _oihw(k), compute_dtype=torch.float16)
