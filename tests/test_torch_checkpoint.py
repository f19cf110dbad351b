"""The port's reader of the JAX package's msgpack checkpoints, its periodic
checkpoint writer, and ``StepTimer``, against the JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import serialization

from tactile_gan_tpu.models import UNetPlusPlus as JaxUNetPlusPlus
from tactile_gan_tpu.models.factory import (
    create_discriminator as jax_create_discriminator,
)
from tactile_gan_tpu.utils import checkpoint as jax_checkpoint
from tactile_gan_tpu.utils import profiling as jax_profiling

from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.eval.runner import load_model
from tactile_gan_torch.models.patch_discriminator import PatchDiscriminator
from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus
from tactile_gan_torch.train.state import make_optimizer
from tactile_gan_torch.utils import checkpoint as port_checkpoint
from tactile_gan_torch.utils.convert import (
    adam_moments, load_adam_state, patchdisc_jax_params_from_state_dict,
    unetpp_jax_params_from_state_dict,
)
from tactile_gan_torch.utils.profiling import StepTimer

torch.set_num_threads(2)

NF, SIZE = 4, 32
# The float32 tolerance of tests/test_torch_models.py (whole-network tanh
# outputs, sums in another order).
F32_TOL = dict(atol=5e-5, rtol=0)


def _draw(tree, seed, scale=0.1):
    """Every leaf from numpy: N(0, scale), norm scales 1 + N(0, scale)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        v = rng.normal(size=leaf.shape) * scale
        if path[-1].key == "scale":
            v = v + 1.0
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _adam_state(tx, params, seed, count):
    """optax.adam's state for ``params`` with drawn moments (nu >= 0)."""
    st = jax.eval_shape(tx.init, params)
    mu = _draw(params, seed, 1e-3)
    nu = jax.tree.map(np.abs, _draw(params, seed + 1, 1e-5))
    return (st[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu),
            ) + tuple(st[1:])


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A final_model.pth written by the JAX package's save_checkpoint: a
    UNet++ and a PatchGAN with drawn weights, both optax Adam states with
    drawn moments, step 7."""
    ex = jnp.zeros((1, SIZE, SIZE, 3))
    gen = _draw(jax.eval_shape(JaxUNetPlusPlus(output_dim=3, nf=NF).init,
                               jax.random.key(0), ex), 3)
    disc = _draw(jax.eval_shape(jax_create_discriminator("patch", NF).init,
                                jax.random.key(1), ex, ex), 4)
    tx = optax.adam(1e-3, b1=0.5, b2=0.99, eps=1e-8)
    opt_g, opt_d = _adam_state(tx, gen, 5, 7), _adam_state(tx, disc, 6, 7)
    path = str(tmp_path_factory.mktemp("jax") / "final_model.pth")
    jax_checkpoint.save_checkpoint(path, gen=gen, disc=disc, opt_g=opt_g,
                                   opt_d=opt_d, step=7)
    return dict(path=path, gen=gen, disc=disc, opt_g=opt_g, opt_d=opt_d)


def test_jax_checkpoint_reads_with_every_key(jax_file):
    ckpt = port_checkpoint.load_checkpoint(jax_file["path"])
    assert not port_checkpoint.is_torch_checkpoint(jax_file["path"])
    assert set(ckpt) == {"gen", "disc", "optimizerG_state_dict",
                         "optimizerD_state_dict", "step"}
    assert ckpt["step"] == 7
    gen, disc = UNetPlusPlus(nf=NF), PatchDiscriminator(nf=NF)
    assert set(ckpt["gen"]) == set(gen.state_dict())
    assert set(ckpt["disc"]) == set(disc.state_dict())
    gen.load_state_dict(ckpt["gen"], strict=True)
    disc.load_state_dict(ckpt["disc"], strict=True)
    for opt in ("optimizerG_state_dict", "optimizerD_state_dict"):
        net = gen if opt == "optimizerG_state_dict" else disc
        assert ckpt[opt]["count"] == 7
        assert set(ckpt[opt]["mu"]) == set(ckpt[opt]["nu"]) == {
            n for n, _ in net.named_parameters()}


def test_jax_checkpoint_generator_forwards_equal_to_jax(jax_file):
    x = np.random.default_rng(8).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    want = np.asarray(JaxUNetPlusPlus(output_dim=3, nf=NF).apply(
        jax_file["gen"], jnp.asarray(x)))
    cfg = TrainConfig(nf=NF, compute_dtype="float32")
    forward, _ = load_model(jax_file["path"], cfg, activation=True,
                            device="cpu")
    got = forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_jax_checkpoint_adam_state_round_trips(jax_file):
    ckpt = port_checkpoint.load_checkpoint(jax_file["path"])
    for key, model, to_jax, state in (
            ("optimizerG_state_dict", UNetPlusPlus(nf=NF),
             unetpp_jax_params_from_state_dict, jax_file["opt_g"]),
            ("optimizerD_state_dict", PatchDiscriminator(nf=NF),
             patchdisc_jax_params_from_state_dict, jax_file["opt_d"])):
        saved = ckpt[key]
        opt = make_optimizer(model.parameters(), 1e-3, 0.5)
        load_adam_state(opt, model, saved["mu"], saved["nu"], saved["count"],
                        dict)
        mu, nu, count = adam_moments(opt, model, to_jax)
        assert count == int(state[0].count) == 7
        for ours, theirs in ((mu, state[0].mu["params"]),
                             (nu, state[0].nu["params"])):
            lo = jax.tree_util.tree_leaves_with_path(ours)
            lt = jax.tree_util.tree_leaves_with_path(theirs)
            assert [p for p, _ in lo] == [p for p, _ in lt]
            for (_, a), (_, b) in zip(lo, lt):
                assert np.array_equal(a, b)


_BLOCKED_READ = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import tactile_gan_torch
from tactile_gan_torch.utils.checkpoint import load_checkpoint
# Every module of the port imports with jax and flax blocked.
modules = sorted(m.name for m in pkgutil.walk_packages(
    tactile_gan_torch.__path__, "tactile_gan_torch."))
for name in modules:
    importlib.import_module(name)
ckpt = load_checkpoint(sys.argv[1])
print(json.dumps({"modules": modules, "step": ckpt["step"],
                  "gen": sum(float(v.double().sum()) for v in ckpt["gen"].values()),
                  "mu": sum(float(v.double().sum()) for v in
                            ckpt["optimizerD_state_dict"]["mu"].values()),
                  "jax_imported": sys.modules["jax"] is not None}))
"""


def test_msgpack_reader_needs_neither_flax_nor_jax(jax_file):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", _BLOCKED_READ,
                          jax_file["path"]], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ckpt = port_checkpoint.load_checkpoint(jax_file["path"])
    assert got["step"] == 7 and not got["jax_imported"]
    assert {"tactile_gan_torch.data.augment",
            "tactile_gan_torch.cli.two_step_test",
            "tactile_gan_torch.cli.visualize_augmentation",
            "tactile_gan_torch.losses.perceptual",
            "tactile_gan_torch.ops.resize",
            "tactile_gan_torch.parallel.mesh",
            "tactile_gan_torch.parallel.tensor_parallel",
            "tactile_gan_torch.utils.dist_ckpt",
            "tactile_gan_torch.entry"} <= set(got["modules"])
    assert got["gen"] == sum(float(v.double().sum())
                             for v in ckpt["gen"].values())
    assert got["mu"] == sum(float(v.double().sum()) for v in
                            ckpt["optimizerD_state_dict"]["mu"].values())


def test_msgpack_ext_types_decode_as_flax_writes_them(tmp_path):
    """Every ext type flax writes: ndarrays (bfloat16 among them), numpy
    scalars and native complex numbers."""
    rng = np.random.default_rng(0)
    tree = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
            "bf16": jnp.asarray(rng.normal(size=(4, 2)), jnp.bfloat16),
            "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
            "scalar": np.float32(2.5), "complex": 1.5 - 2.0j, "n": 3}
    path = str(tmp_path / "tree.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(tree))
    got = port_checkpoint.read_msgpack(path)
    want = serialization.msgpack_restore(open(path, "rb").read())
    assert np.array_equal(got["f32"], want["f32"])
    assert got["bf16"].dtype == np.float32
    assert np.array_equal(got["bf16"], np.asarray(want["bf16"], np.float32))
    assert got["i32"].dtype == np.int32 and np.array_equal(got["i32"],
                                                           want["i32"])
    assert got["scalar"] == want["scalar"] == np.float32(2.5)
    assert got["complex"] == want["complex"] == 1.5 - 2.0j
    assert got["n"] == 3


def test_msgpack_chunked_leaf_is_refused_by_name(tmp_path, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    path = str(tmp_path / "chunked.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"gen": {"w": np.zeros(100, np.float32)}}))
    with pytest.raises(NotImplementedError, match="chunks"):
        port_checkpoint.read_msgpack(path)


# ---------------------------------------------------------------------------
# StepTimer against the JAX package's.
# ---------------------------------------------------------------------------

def test_step_timer_summary_matches_jax():
    durations = [0.012, 0.5, 0.031, 0.2, 0.0071, 0.09, 0.4]
    ours, theirs = StepTimer(), jax_profiling.StepTimer()
    assert ours.summary() == theirs.summary() == {}
    ours.durations, theirs.durations = list(durations), list(durations)
    assert ours.summary() == theirs.summary()
    assert set(ours.summary()) == {"steps", "mean_s", "p50_s", "p90_s"}


def test_step_timer_stop_on_a_cpu_tensor_records_the_step():
    timer = StepTimer()
    for _ in range(3):
        timer.start()
        timer.stop(block_on=torch.ones(2))
    timer.start()
    timer.stop()
    assert timer.summary()["steps"] == 4
    assert all(d >= 0 for d in timer.durations)
