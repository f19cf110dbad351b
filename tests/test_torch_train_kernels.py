"""The port's backward kernels, through their plain PyTorch versions and the
autograd Functions on the CPU, against the Pallas kernels (Mosaic
interpreter) and JAX's VJPs on the same numpy inputs: kernel C (instance
norm + act backward), kernel B's dx use and kernel D (weight gradient).
The CUDA kernels are held against these plain versions on the card by
chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.ops.conv import conv2d as jax_conv2d
from tactile_gan_tpu.ops.packed_row import _dk_from_db, _rot_t
from tactile_gan_tpu.ops.pallas.conv3x3 import (
    conv3x3_packed, conv3x3_packed_wgrad, pack_w, unpack_w,
)
from tactile_gan_tpu.ops.pallas.instance_norm import (
    instance_norm_act as pallas_instance_norm_act,
)

from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus
from tactile_gan_torch.models.blocks import init_weights
from tactile_gan_torch.ops.kernels import conv3x3 as kb
from tactile_gan_torch.ops.kernels import conv3x3_wgrad as kd
from tactile_gan_torch.ops.kernels import instance_norm as ka

torch.set_num_threads(2)

# One bf16 rounding of the output on each side: a flipped rounding is one
# bf16 ulp (<= 2^-7 of the value); 2^-6 leaves room for the next binade.
BF16_TOL = dict(atol=1e-2, rtol=2.0 ** -6)


def _bf16_round(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


# ---------------------------------------------------------------------------
# Kernel C: instance norm + affine + act, backward.
# ---------------------------------------------------------------------------

# The forms of the Pallas kernel: lane-fold, batch-lane, per-batch.
IN_SHAPES = {"lane_fold": (2, 8, 8, 16), "batch_lane": (2, 8, 8, 64),
             "per_batch": (3, 8, 8, 24)}


def _in_case(form, dtype, act, affine):
    rng = np.random.default_rng(23)
    shape = IN_SHAPES[form]
    c = shape[-1]
    # A mean offset (|mean| / std about 1/3), where single- and two-pass
    # statistics part ways.
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    s = (1 + 0.5 * rng.normal(size=(c,))).astype(np.float32)
    o = (0.5 * rng.normal(size=(c,))).astype(np.float32)
    if dtype == "bfloat16":
        x, g = _bf16_round(x), _bf16_round(g)
    jdt = jnp.dtype(dtype)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    if affine:
        _, vjp = jax.vjp(lambda a, b, d: pallas_instance_norm_act(
            a, b, d, act=act, interpret=True), jx, jnp.asarray(s),
            jnp.asarray(o))
        want = [np.asarray(v, np.float32) for v in vjp(jg)]
    else:
        _, vjp = jax.vjp(lambda a: pallas_instance_norm_act(
            a, act=act, interpret=True), jx)
        want = [np.asarray(vjp(jg)[0], np.float32)]
    tdt = getattr(torch, dtype)
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    ts = torch.from_numpy(s) if affine else None
    to = torch.from_numpy(o) if affine else None
    return tx, tg, ts, to, want


def _in_check(got, want, dtype):
    # float32: the Pallas backward's single-pass statistics against the
    # plain version's two-pass ones, and float32 sums over 128-192 pixels in
    # another order. bfloat16: dx rounded once on each side; dscale and
    # doffset are float32 sums of the same rounded inputs.
    dx_tol = BF16_TOL if dtype == "bfloat16" else dict(atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[0].float().numpy(), want[0], **dx_tol)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.float().numpy(), b, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("form", sorted(IN_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", None])
def test_instance_norm_backward_plain_matches_pallas_vjp(form, dtype, act):
    tx, tg, ts, to, want = _in_case(form, dtype, act, True)
    got = ka.instance_norm_act_backward_plain(
        tx, tg, ka.instance_norm_stats_plain(tx), ts, to, act=act)
    assert got[0].dtype == tg.dtype  # dx follows the gradient's dtype
    _in_check(got, want, dtype)


@pytest.mark.parametrize("form", sorted(IN_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_instance_norm_function_backward_matches_pallas_vjp(form, dtype,
                                                            affine):
    """The same comparison through the port's autograd Function."""
    tx, tg, ts, to, want = _in_case(form, dtype, "relu", affine)
    leaves = [tx.requires_grad_()]
    if affine:
        leaves += [ts.requires_grad_(), to.requires_grad_()]
    y = ka.instance_norm_act(tx, ts, to, act="relu")
    got = torch.autograd.grad(y, leaves, tg)
    _in_check(got, want, dtype)


# ---------------------------------------------------------------------------
# Kernel B's dx use and kernel D: the input and weight gradients.
# ---------------------------------------------------------------------------

def _conv_case(n, h, w, c, co, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, co)) * 0.1).astype(np.float32)  # HWIO
    g = rng.normal(size=(n, h, w, co)).astype(np.float32)
    if dtype == "bfloat16":
        x, g = _bf16_round(x), _bf16_round(g)
    return x, k, g


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


PACKED = [(1, 16, 16, 64, 64), (2, 8, 12, 16, 16), (1, 8, 8, 8, 32),
          (2, 8, 8, 32, 16)]


@pytest.mark.parametrize("n,h,w,c,co", PACKED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_conv3x3_dgrad_plain_matches_pallas_rot_t(n, h, w, c, co, dtype,
                                                  compute):
    """dx is the packed Pallas conv of g with _rot_t(k)
    (ops/packed_row.py:310)."""
    x, k, g = _conv_case(n, h, w, c, co, 31, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = unpack_w(conv3x3_packed(pack_w(jnp.asarray(g, jdt)),
                                   _rot_t(jnp.asarray(k)), h=h,
                                   interpret=True,
                                   compute_dtype=jnp.dtype(compute)), h, c)
    tg = torch.from_numpy(g).to(tdt)
    got = kb.conv3x3_dgrad_plain(tg, _oihw(k),
                                 compute_dtype=getattr(torch, compute))
    assert got.dtype == tdt and got.shape == (n, h, w, c)
    # Same rounded operands, exact products, float32 sums of 9*Co terms in
    # another order.
    tol = BF16_TOL if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("n,h,w,c,co", PACKED)
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_conv3x3_wgrad_plain_matches_pallas_wgrad(n, h, w, c, co, compute):
    """dk is the Pallas wgrad kernel's (dBmid, dBlr) folded by _dk_from_db."""
    x, _, g = _conv_case(n, h, w, c, co, 37)
    cd = jnp.dtype(compute)
    dbm, dbl = conv3x3_packed_wgrad(pack_w(jnp.asarray(x)),
                                    pack_w(jnp.asarray(g)), h=h,
                                    interpret=True, compute_dtype=cd,
                                    block_h=4)  # several row blocks a run
    want = np.asarray(_dk_from_db(dbm, dbl, c, co)).transpose(3, 2, 0, 1)
    got = kd.conv3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 compute_dtype=getattr(torch, compute))
    assert got.dtype == torch.float32 and got.shape == (co, c, 3, 3)
    # Same rounded operands, exact products; float32 sums of N*H*W terms
    # (up to 256 here) in another order, relative to the largest entry.
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                               rtol=1e-5)


@pytest.mark.parametrize("cin", [96, 192, 384])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_conv3x3_gradients_match_jax_vjp_wide_input(cin, compute):
    """Cin > 64 (the concatenated node inputs) is beyond the Pallas
    kernels, so dx and dk are held against jax.vjp of the JAX package's
    conv2d with the same dtype policy, through the port's Function."""
    x, k, g = _conv_case(1, 8, 8, cin, 64, cin)
    cd = jnp.dtype(compute)
    _, vjp = jax.vjp(lambda a, b: jax_conv2d(a, b, padding=1,
                                             compute_dtype=cd),
                     jnp.asarray(x), jnp.asarray(k))
    want_dx, want_dk = (np.asarray(v, np.float32) for v in vjp(jnp.asarray(g)))
    tx = torch.from_numpy(x).requires_grad_()
    tw = _oihw(k).requires_grad_()
    y = kb.conv3x3(tx, tw, compute_dtype=getattr(torch, compute))
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g))
    want_dk = want_dk.transpose(3, 2, 0, 1)
    if compute == "float32":
        # float32 sums of up to 3,456 (dx) or 64 (dk) terms in another order.
        np.testing.assert_allclose(dx.numpy(), want_dx, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(dw.numpy(), want_dk, atol=1e-4, rtol=1e-4)
    else:
        # JAX rounds its bf16 conv outputs, dx and dk among them (2^-9
        # relative); the port keeps the float32 accumulator.
        np.testing.assert_allclose(dx.numpy(), want_dx, atol=1e-3,
                                   rtol=2.0 ** -8)
        np.testing.assert_allclose(dw.numpy(), want_dk,
                                   atol=1e-3 * np.abs(want_dk).max(),
                                   rtol=2.0 ** -8)


@pytest.mark.parametrize("cin,co", [(64, 64), (24, 16), (136, 32)])
def test_conv3x3_function_gradients_are_the_plain_versions(cin, co):
    x, k, g = _conv_case(2, 6, 10, cin, co, 5)
    tx = torch.from_numpy(x).requires_grad_()
    tw = _oihw(k).requires_grad_()
    y = kb.conv3x3(tx, tw)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g))
    tg = torch.from_numpy(g)
    assert torch.equal(dx, kb.conv3x3_dgrad_plain(tg, tw.detach()))
    assert torch.equal(dw, kd.conv3x3_wgrad_plain(tx.detach(), tg))


def test_dgrad_weight_relayout_is_cached_beside_the_forward_one():
    w = torch.nn.Parameter(torch.randn(64, 24, 3, 3))
    fwd = kb._kernel_weight(w, torch.bfloat16)
    dx = kb._kernel_weight(w, torch.bfloat16, dgrad=True)
    assert kb._kernel_weight(w, torch.bfloat16) is fwd
    assert kb._kernel_weight(w, torch.bfloat16, dgrad=True) is dx
    # [9][Co_dx = 24 padded to a 32-wide tile][Cin_dx = 64] for bf16.
    assert dx.shape == (9, 32, 64) and not dx[:, 24:].any()
    torch.testing.assert_close(
        dx[:, :24], kb.relayout_weight(kb.rot_t(w.detach()), torch.bfloat16))
    with torch.no_grad():
        w.add_(1.0)  # an optimizer step rebuilds both
    assert kb._kernel_weight(w, torch.bfloat16, dgrad=True) is not dx
    f32 = kb._kernel_weight(w, torch.float32, dgrad=True)
    assert f32.shape == (9, 64, 32) and f32.dtype == torch.float32


@pytest.mark.parametrize("n,h,w,cin", [(4, 256, 256, 64), (4, 256, 256, 384),
                                       (2, 37, 53, 24), (1, 9, 17, 8)])
def test_wgrad_launch_plan_covers_every_tile(n, h, w, cin):
    per, chunks = kd.launch_plan(n, h, w, cin)
    tiles = n * -(-h // 8) * -(-w // 32)
    assert per * chunks >= tiles > per * (chunks - 1)
    if tiles >= 264:  # the training shapes fill 132 SMs in one wave
        assert 132 <= chunks * -(-cin // 32) <= 264


# ---------------------------------------------------------------------------
# First order only, and the autograd hole of the first slice.
# ---------------------------------------------------------------------------

def test_double_backward_raises_with_the_op_name():
    x = torch.randn(1, 4, 4, 16, requires_grad=True)
    s = torch.ones(16, requires_grad=True)
    y = ka.instance_norm_act(x, s, torch.zeros(16), act="relu")
    with pytest.raises(RuntimeError, match="instance_norm_act: double backward"):
        torch.autograd.grad(y.square().sum(), x, create_graph=True)
    w = torch.randn(16, 16, 3, 3, requires_grad=True)
    y = kb.conv3x3(x, w)
    with pytest.raises(RuntimeError, match="conv3x3: double backward"):
        torch.autograd.grad(y.square().sum(), w, create_graph=True)
    # First order is unaffected.
    (gx,) = torch.autograd.grad(kb.conv3x3(x, w).sum(), x)
    assert gx.shape == x.shape


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_every_generator_parameter_gets_a_gradient(compute):
    """On the CPU the kernel ops are autograd Functions whose backward runs
    the plain versions, so gen(x).sum().backward() reaches every norm and
    row-0 conv, as on the card."""
    gen = UNetPlusPlus(nf=4, compute_dtype=compute)
    init_weights(gen, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32))
    gen(x).sum().backward()
    missing = [n for n, p in gen.named_parameters()
               if p.grad is None or not bool(p.grad.abs().sum() > 0)]
    assert not missing, missing
    assert len(list(gen.parameters())) == 15 * 2 * 3 + 2
