"""The ``--space_to_depth`` UNet++ variant against the JAX package:
``space_to_depth2`` / ``depth_to_space2``, every parameter's shape against
``jax.eval_shape`` of the JAX module, the forward in float32 and bf16
compute, its checkpoints and Adam moments both ways, the row-0 kernel
routing, one training step against the JAX step, and the CLIs."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tactile_gan_tpu.models import UNetPlusPlus as JaxUNetPlusPlus
from tactile_gan_tpu.models.factory import (
    create_generator as jax_create_generator,
)
from tactile_gan_tpu.ops.resize import (
    depth_to_space2 as jax_depth_to_space2,
    space_to_depth2 as jax_space_to_depth2,
)
from tactile_gan_tpu.utils import checkpoint as jax_checkpoint

from test_torch_checkpoint import _adam_state
from test_torch_models import F32_TOL
from test_torch_train import _randomize, _write_train_pairs
from test_torch_variants import check_variant_step

from tactile_gan_torch.cli import test as test_cli
from tactile_gan_torch.cli import train as train_cli
from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.eval.runner import load_model
from tactile_gan_torch.models.factory import create_generator
from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus
from tactile_gan_torch.ops.resize import depth_to_space2, space_to_depth2
from tactile_gan_torch.train.state import make_optimizer
from tactile_gan_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tactile_gan_torch.utils.convert import (
    adam_moments, load_adam_state, unetpp_jax_params_from_state_dict,
    unetpp_state_dict_from_jax,
)

torch.set_num_threads(2)

NF, SIZE, BATCH = 4, 64, 2
# bf16 compute: one rounding of each conv's operands on each side, through
# the whole network (tests/test_torch_models.py's bf16 limit).
BF16_TOL = dict(atol=0.1, rtol=0)


@pytest.mark.parametrize("shape", [(2, 4, 6, 3), (1, 8, 2, 5), (3, 2, 2, 1)])
def test_space_to_depth_round_trips_and_equals_jax(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    folded = space_to_depth2(torch.from_numpy(x))
    n, h, w, c = shape
    assert folded.shape == (n, h // 2, w // 2, 4 * c)
    np.testing.assert_array_equal(folded.numpy(),
                                  np.asarray(jax_space_to_depth2(x)))
    np.testing.assert_array_equal(depth_to_space2(folded).numpy(), x)
    y = np.random.default_rng(2).normal(size=(n, h, w, 4 * c)).astype(
        np.float32)
    np.testing.assert_array_equal(depth_to_space2(torch.from_numpy(y)).numpy(),
                                  np.asarray(jax_depth_to_space2(y)))


def _jax_params(seed, nf=NF):
    model = JaxUNetPlusPlus(output_dim=3, nf=nf, space_to_depth=True)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    return _randomize(shapes, seed)


@pytest.mark.parametrize("nf", [4, 6])
def test_parameter_shapes_equal_jax_eval_shape(nf):
    """Stem 12 input channels, row 1 nf/2, nested row 0 2nf * col + 2nf,
    the head nf/2, every other leaf as in UNet++."""
    want = jax.eval_shape(JaxUNetPlusPlus(output_dim=3, nf=nf,
                                          space_to_depth=True).init,
                          jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    ours = unetpp_jax_params_from_state_dict(
        UNetPlusPlus(nf=nf, space_to_depth=True).state_dict())
    lo = jax.tree_util.tree_leaves_with_path(ours)
    lt = jax.tree_util.tree_leaves_with_path(want["params"])
    assert [p for p, _ in lo] == [p for p, _ in lt]
    for (path, a), (_, b) in zip(lo, lt):
        assert a.shape == b.shape, path
    sd = UNetPlusPlus(nf=nf, space_to_depth=True).state_dict()
    assert sd["conv0_0.layer.0.weight"].shape == (2 * nf, 12, 3, 3)
    assert sd["conv1_0.layer.0.weight"].shape == (2 * nf, nf // 2, 3, 3)
    assert sd["conv0_3.layer.0.weight"].shape == (2 * nf, 8 * nf, 3, 3)
    assert sd["downfeature.conv.weight"].shape == (3, nf // 2, 1, 1)


def test_odd_nf_and_other_generators_are_refused():
    with pytest.raises(ValueError, match="even nf"):
        UNetPlusPlus(nf=5, space_to_depth=True)
    for name in ("UNet", "BCDUNet"):
        with pytest.raises(ValueError, match="only supported for UNet"):
            create_generator(name, nf=4, space_to_depth=True)
        with pytest.raises(ValueError, match="only supported for UNet"):
            jax_create_generator(name, nf=4, space_to_depth=True)


@pytest.mark.parametrize("nf,kernel", [(4, True), (32, True), (64, False)])
def test_row0_routing_follows_its_real_width(nf, kernel):
    """Row 0 is 2nf wide: kernel B (and B-dx, D) where 2nf <= 64, the
    library conv above, as the JAX package routes it; the stem's first conv
    (12 input channels) stays on the library."""
    model = UNetPlusPlus(nf=nf, space_to_depth=True)
    for col in range(5):
        block = getattr(model, f"conv0_{col}")
        assert block.kernel_convs == ((kernel and col > 0), kernel)
    assert model.conv1_0.kernel_convs == (False, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    params = _jax_params(3)
    x = np.random.default_rng(4).uniform(
        -1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = np.asarray(JaxUNetPlusPlus(output_dim=3, nf=NF, space_to_depth=True,
                                      compute_dtype=jdt).apply(params, x))
    model = UNetPlusPlus(nf=NF, space_to_depth=True,
                         compute_dtype=getattr(torch, dtype))
    model.load_state_dict(unetpp_state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (BATCH, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, **(
        F32_TOL if dtype == "float32" else BF16_TOL))


def test_jax_checkpoint_is_served_by_load_model(tmp_path):
    """A JAX msgpack final_model.pth of the variant (weights and Adam
    moments) is served by load_model, equal to the JAX forward; its moments
    carry into a torch Adam and back unchanged."""
    params = _jax_params(5)
    opt_state = _adam_state(optax.adam(1e-3, b1=0.9, b2=0.99), params, 6, 3)
    mu, nu = opt_state[0].mu, opt_state[0].nu
    path = str(tmp_path / "final_model.pth")
    jax_checkpoint.save_checkpoint(path, gen=params, disc={}, opt_g=opt_state,
                                   opt_d=(), step=3)
    cfg = TrainConfig(nf=NF, space_to_depth=True, compute_dtype="float32")
    forward, gen = load_model(path, cfg, device="cpu")
    x = np.random.default_rng(8).uniform(
        -1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    want = JaxUNetPlusPlus(output_dim=3, nf=NF, space_to_depth=True).apply(
        params, x)
    np.testing.assert_allclose(forward(torch.from_numpy(x)).numpy(),
                               np.asarray(want), **F32_TOL)
    saved = load_checkpoint(path)["optimizerG_state_dict"]
    opt = make_optimizer(gen.parameters(), 1e-3, 0.9)
    load_adam_state(opt, gen, saved["mu"], saved["nu"], saved["count"], dict)
    back_mu, back_nu, count = adam_moments(opt, gen,
                                           unetpp_jax_params_from_state_dict)
    assert count == 3
    for ours, theirs in ((back_mu, mu), (back_nu, nu)):
        for (_, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(ours),
                jax.tree_util.tree_leaves_with_path(theirs["params"])):
            np.testing.assert_array_equal(a, b)


def test_port_checkpoint_reads_into_jax(tmp_path):
    model = UNetPlusPlus(nf=NF, space_to_depth=True)
    model.load_state_dict(unetpp_state_dict_from_jax(_jax_params(9)))
    path = str(tmp_path / "final_model.pth")
    save_checkpoint(path, gen=model.state_dict())
    theirs = jax_checkpoint.load_checkpoint(path)
    x = np.random.default_rng(10).uniform(
        -1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    want = JaxUNetPlusPlus(output_dim=3, nf=NF, space_to_depth=True).apply(
        {"params": theirs["gen"]["params"]}, x)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


def test_space_to_depth_step_matches_jax():
    check_variant_step("space_to_depth")


def test_cli_trains_and_serves_the_variant(tmp_path):
    root = str(tmp_path)
    _write_train_pairs(os.path.join(root, "data"), n=2, size=32, seed=5)
    trainer = train_cli.main([
        "--data", os.path.join(root, "data"), "--nf", "4", "--batch_size",
        "2", "--image_size", "32", "--total_epochs", "1", "--lambda_per",
        "0", "--compute_dtype", "float32", "--threads", "1",
        "--space_to_depth", "--folder_save", "s2d", "--device", "cpu"])
    assert trainer.gen.space_to_depth
    os.makedirs(os.path.join(root, "data", "test"))
    os.rename(os.path.join(root, "data", "train", "source"),
              os.path.join(root, "data", "test", "source"))
    os.rename(os.path.join(root, "data", "train", "tactile"),
              os.path.join(root, "data", "test", "tactile"))
    metrics = test_cli.main(["--folder", "s2d", "--work_root", root,
                             "--data", "data", "--device", "cpu"])
    assert all(np.isfinite(v) for v in metrics.values())
    out = os.path.join(root, "Outputs", "s2d", "out")
    assert sorted(os.listdir(out)) == ["1.png", "2.png"]
