"""The port's UNet++ and ops against the JAX package on the same numpy
inputs and weights; weight conversion and checkpoint interchange."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.models import UNetPlusPlus as JaxUNetPlusPlus
from tactile_gan_tpu.ops.conv import conv2d as jax_conv2d
from tactile_gan_tpu.ops.norm import instance_norm as jax_instance_norm
from tactile_gan_tpu.ops.pool import avg_pool2 as jax_avg_pool2
from tactile_gan_tpu.ops.resize import upsample_nearest2 as jax_upsample
from tactile_gan_tpu.utils import checkpoint as jax_checkpoint
from tactile_gan_tpu.utils.torch_migrate import unetpp_from_torch

from tactile_gan_torch.models.factory import create_generator
from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus
from tactile_gan_torch.ops.conv import conv2d
from tactile_gan_torch.ops.norm import instance_norm
from tactile_gan_torch.ops.pool import avg_pool2
from tactile_gan_torch.ops.resize import upsample_nearest2
from tactile_gan_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tactile_gan_torch.utils.convert import (
    unetpp_jax_params_from_state_dict, unetpp_state_dict_from_jax,
)

torch.set_num_threads(2)

NF, SIZE, BATCH = 8, 32, 2
# Whole-network float32 agreement on tanh outputs: sums in another order
# (and the Pallas form's single-pass variance), amplified by the instance
# norms over the 2x2 maps of the deepest row.
F32_TOL = dict(atol=5e-5, rtol=0)


def _jax_params(seed, nf=NF, size=SIZE):
    """A JAX UNet++ param tree with every leaf drawn from numpy: conv
    kernels N(0, 0.1), norm scales 1 + N(0, 0.1), offsets and the head bias
    N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    model = JaxUNetPlusPlus(output_dim=3, nf=nf)
    tree = model.init(jax.random.key(0), jnp.zeros((1, size, size, 3)))

    def draw(path, leaf):
        v = rng.normal(size=leaf.shape) * 0.1
        if path[-1].key == "scale":
            v = v + 1.0
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _input(seed, n=BATCH, size=SIZE):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


def _port(params, compute_dtype, activation=True):
    m = UNetPlusPlus(nf=NF, activation=activation, compute_dtype=compute_dtype)
    m.load_state_dict(unetpp_state_dict_from_jax(params), strict=True)
    return m.eval()


def _port_forward(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


# Both JAX forms: the Pallas form (fused IN kernel on rows 1-4 in interpret
# mode, packed row 0) and the serving form (plain XLA norms).
JAX_FORMS = {"pallas_packed": dict(use_pallas=True, packed_row0=True),
             "serving": dict(use_pallas=False)}


@pytest.mark.parametrize("form", sorted(JAX_FORMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generator_matches_jax(form, dtype):
    params = _jax_params(1)
    x = _input(2)
    jm = JaxUNetPlusPlus(output_dim=3, nf=NF, compute_dtype=jnp.dtype(dtype),
                         **JAX_FORMS[form])
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = _port_forward(_port(params, getattr(torch, dtype)), x)
    assert got.shape == want.shape == (BATCH, SIZE, SIZE, 3)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        # bf16 rounds at other places in the two: the port keeps its row-0
        # conv outputs in float32 (kernel B), JAX rounds them to bf16 (and
        # keeps the packed row bf16-resident). Each lies about 0.05 (max) and
        # 0.005 (mean) from the float32 network at these weights, so the
        # port must agree with JAX to twice that and be no further from the
        # float32 network than twice JAX's own bf16 error.
        np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
        assert np.abs(got - want).mean() < 1e-2
        f32 = JaxUNetPlusPlus(output_dim=3, nf=NF, **JAX_FORMS["serving"])
        truth = np.asarray(f32.apply(params, jnp.asarray(x)))
        assert (np.abs(got - truth).mean()
                <= 2 * np.abs(want - truth).mean())


def test_generator_without_tanh_matches_jax():
    params = _jax_params(3)
    x = _input(4, n=1)
    jm = JaxUNetPlusPlus(output_dim=3, nf=NF, activation=False)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = _port_forward(_port(params, torch.float32, activation=False), x)
    assert np.abs(want).max() > 1.0  # the head really is unbounded
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_state_dict_uses_reference_names():
    sd = UNetPlusPlus(nf=NF).state_dict()
    want = {"downfeature.conv.weight", "downfeature.conv.bias"}
    for r in range(5):
        for c in range(5 - r):
            for i in (0, 3):
                want.add(f"conv{r}_{c}.layer.{i}.weight")
            for i in (1, 4):
                want |= {f"conv{r}_{c}.layer.{i}.weight",
                         f"conv{r}_{c}.layer.{i}.bias"}
    assert set(sd) == want


def test_convert_round_trip_is_bit_exact():
    """JAX params -> port state_dict -> the JAX package's own migration
    (torch_migrate.unetpp_from_torch) and the port's inverse restore every
    leaf bit for bit."""
    params = _jax_params(5)
    sd = unetpp_state_dict_from_jax(params)
    via_migrate = unetpp_from_torch({k: v.numpy() for k, v in sd.items()})
    via_port = unetpp_jax_params_from_state_dict(sd)
    flat = jax.tree_util.tree_leaves_with_path(params["params"])
    for other in (via_migrate, via_port):
        other_flat = jax.tree_util.tree_leaves_with_path(other)
        assert [p for p, _ in flat] == [p for p, _ in other_flat]
        for (_, a), (_, b) in zip(flat, other_flat):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_port_checkpoint_loads_in_jax_and_forwards_equal(tmp_path):
    params = _jax_params(7)
    port = _port(params, torch.float32)
    path = os.path.join(str(tmp_path), "models", "m", "final_model.pth")
    save_checkpoint(path, gen=port.state_dict())

    ckpt = jax_checkpoint.load_checkpoint(path)
    jm = JaxUNetPlusPlus(output_dim=3, nf=NF)
    x = _input(8)
    want = np.asarray(jm.apply({"params": ckpt["gen"]["params"]},
                               jnp.asarray(x)))
    reloaded = UNetPlusPlus(nf=NF)
    reloaded.load_state_dict(load_checkpoint(path)["gen"], strict=True)
    got = _port_forward(reloaded.eval(), x)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_jax_tree_of_no_generator_is_refused(tmp_path):
    path = os.path.join(str(tmp_path), "final_model.pth")
    jax_checkpoint.save_checkpoint(path, gen={}, disc={}, opt_g={}, opt_d={},
                                   step=0)
    with pytest.raises(ValueError, match="not a JAX generator tree"):
        load_checkpoint(path)


def test_factory_refuses_an_unknown_generator():
    with pytest.raises(NameError, match="not a valid generator"):
        create_generator("nope")


# ---------------------------------------------------------------------------
# Plain ops against the JAX ops.
# ---------------------------------------------------------------------------

def test_instance_norm_matches_jax():
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(2, 6, 10, 12)) * 2 + 3).astype(np.float32)
    s = rng.normal(size=(12,)).astype(np.float32)
    o = rng.normal(size=(12,)).astype(np.float32)
    want = np.asarray(jax_instance_norm(jnp.asarray(x), jnp.asarray(s),
                                        jnp.asarray(o)))
    got = instance_norm(torch.from_numpy(x), torch.from_numpy(s),
                        torch.from_numpy(o)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("k,stride,padding,bias", [(3, 1, 1, False),
                                                   (1, 1, 0, True),
                                                   (4, 2, 1, False)])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_conv2d_matches_jax(k, stride, padding, bias, compute):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    w = (rng.normal(size=(k, k, 6, 5)) * 0.2).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32) if bias else None
    want = np.asarray(jax_conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding,
        bias=None if b is None else jnp.asarray(b),
        compute_dtype=jnp.dtype(compute)))
    got = conv2d(torch.from_numpy(x),
                 torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                 stride=stride, padding=padding,
                 bias=None if b is None else torch.from_numpy(b),
                 compute_dtype=getattr(torch, compute))
    assert got.dtype == torch.float32
    # Both round the bf16 conv output once (2^-9 relative); float32 sums in
    # another order.
    tol = dict(atol=1e-5, rtol=1e-5) if compute == "float32" else \
        dict(atol=1e-3, rtol=2.0 ** -7)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_pool_and_upsample_match_jax():
    x = np.random.default_rng(4).normal(size=(2, 6, 4, 5)).astype(np.float32)
    # The mean of four float32 values, summed in another order.
    np.testing.assert_allclose(
        avg_pool2(torch.from_numpy(x)).numpy(),
        np.asarray(jax_avg_pool2(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        upsample_nearest2(torch.from_numpy(x)).numpy(),
        np.asarray(jax_upsample(jnp.asarray(x))))
    with pytest.raises(ValueError):
        avg_pool2(torch.zeros(1, 3, 4, 2))
