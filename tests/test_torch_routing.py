"""The port at UNet++ widths other than the default, and the trainer's
--debug_nans and --profile_dir: kernel B's Co domain and each block's
routing, kernel A at any C against the Pallas kernel, UNet++ at such widths
against the JAX module, the NaN guard and the first-epoch trace."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from tactile_gan_tpu.models import UNetPlusPlus as JaxUNetPlusPlus
from tactile_gan_tpu.ops.pallas.instance_norm import (
    instance_norm_act as pallas_instance_norm_act,
)

from tactile_gan_torch.cli import train as port_cli
from tactile_gan_torch.core.config import config_from_args
from tactile_gan_torch.eval.runner import evaluate_folder
from tactile_gan_torch.models.blocks import DoubleConvBlock
from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus
from tactile_gan_torch.ops.kernels import conv3x3 as kb
from tactile_gan_torch.ops.kernels import instance_norm as ka
from tactile_gan_torch.utils.convert import unetpp_state_dict_from_jax

torch.set_num_threads(2)

SIZE, BATCH = 32, 2
# Whole-network float32 agreement on tanh outputs, as in
# tests/test_torch_models.py: sums in another order, amplified by the
# instance norms over the 2x2 maps of the deepest row.
F32_TOL = dict(atol=5e-5, rtol=0)


@pytest.mark.parametrize("co,want", [
    (1, True), (8, True), (12, True), (16, True), (24, True), (40, True),
    (64, True), (65, False), (128, False)])
def test_kernel_b_domain(co, want):
    """B takes every Co the JAX package gives its packed kernel (2 Co <=
    128), whatever Cin."""
    assert kb.supported(co) is want


@pytest.mark.parametrize("c", [8, 24, 64, 12, 3])
def test_kernel_a_domain(c):
    """Kernel A's function at any C, 8's multiples or not, against the
    Pallas instance_norm_act (Mosaic interpreter), which takes any C: the
    wrapper on a CPU tensor, float32."""
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(2, 5, 7, c)) * 3 + 1).astype(np.float32)
    s = (1 + 0.5 * rng.normal(size=(c,))).astype(np.float32)
    o = (0.5 * rng.normal(size=(c,))).astype(np.float32)
    want = pallas_instance_norm_act(jnp.asarray(x), jnp.asarray(s),
                                    jnp.asarray(o), act="relu", interpret=True)
    got = ka.instance_norm_act(torch.from_numpy(x), torch.from_numpy(s),
                               torch.from_numpy(o), act="relu")
    # The Pallas kernel's single-pass E[x^2]-m^2 against the plain two-pass
    # variance, as in tests/test_torch_kernels.py.
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("nf", [8, 12, 24, 64, 128])
def test_blocks_route_by_kernel_domain(nf):
    """Row 0 of UNet++ runs kernel B wherever nf <= 64 (the stem's first
    conv never), the library conv at nf 128; deeper rows never run B."""
    b = nf <= 64
    for col in range(5):
        cin = 3 if col == 0 else nf * col + 2 * nf
        block = DoubleConvBlock(cin, nf, compute_dtype=torch.bfloat16,
                                full_res=True, stem=col == 0)
        assert block.kernel_convs == (b and col > 0, b)
    deep = DoubleConvBlock(nf, 2 * nf, compute_dtype=torch.bfloat16)
    assert deep.kernel_convs == (False, False)


def _jax_params(seed, nf):
    rng = np.random.default_rng(seed)
    tree = JaxUNetPlusPlus(output_dim=3, nf=nf).init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))

    def draw(path, leaf):
        v = rng.normal(size=leaf.shape) * 0.1
        if path[-1].key == "scale":
            v = v + 1.0
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.mark.parametrize("nf", [8, 12, 24])
def test_unetpp_outside_kernel_domains_matches_jax(nf):
    """nf 8 and 24 give row 0 a Co off B's 16/32/64 entries, nf 12 also
    Cin and norm widths off multiples of 8; the port computes the JAX
    module's function there with kernel B on row 0 (its tail instantiation
    on the card) and kernel A on every norm."""
    params = _jax_params(nf, nf)
    x = np.random.default_rng(nf + 1).uniform(
        -1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(JaxUNetPlusPlus(output_dim=3, nf=nf).apply(
        params, jnp.asarray(x)))
    port = UNetPlusPlus(nf=nf)
    port.load_state_dict(unetpp_state_dict_from_jax(params), strict=True)
    assert port.conv0_1.kernel_convs == (True, True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (BATCH, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, **F32_TOL)


def _write_pairs(root, split, n, size=SIZE, seed=0):
    rng = np.random.default_rng(seed)
    for sub, name in (("source", "s_{:04d}.png"), ("tactile", "t_{:04d}.tiff")):
        d = os.path.join(root, "data", split, sub)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (size, size, 3),
                                         dtype=np.uint8)).save(
                os.path.join(d, name.format(i)))


def _train(root, extra=()):
    _write_pairs(root, "train", n=4)
    return port_cli.main([
        "--data", os.path.join(root, "data"), "--nf", "8", "--batch_size",
        "2", "--image_size", str(SIZE), "--total_epochs", "1",
        "--epoch_constant", "1", "--compute_dtype", "float32", "--threads",
        "2", "--folder_save", "m", "--device", "cpu", *extra])


def test_debug_nans_raises_on_a_diverging_run(tmp_path):
    """An infinite L1 weight gives the generator an infinite gradient at
    the first step, so the second step's losses are NaN: with --debug_nans
    the trainer raises FloatingPointError after that step, as the JAX
    trainer raises; without it the run finishes with the non-finite loss
    recorded."""
    extra = ("--lambda_a", "inf", "--lambda_per", "0")
    with pytest.raises(FloatingPointError,
                       match=r"non-finite losses .*\(epoch 1, step 2\)"):
        _train(str(tmp_path / "a"), extra + ("--debug_nans",))
    trainer = _train(str(tmp_path / "b"), extra)
    assert not np.isfinite(trainer.gen_loss[0])


def test_profile_dir_traces_the_first_epoch(tmp_path, capsys):
    """--profile_dir writes one torch.profiler trace (the first epoch of
    two) as Chrome-trace JSON; the trained folder is served with the VGG
    fallback note and its banner."""
    prof = tmp_path / "prof"
    trainer = _train(str(tmp_path), ("--profile_dir", str(prof),
                                     "--total_epochs", "2"))
    assert len(trainer.gen_loss) == 2
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(prof / traces[0]) as f:
        assert '"traceEvents"' in f.read()
    assert trainer.vgg_random_fallback
    _write_pairs(str(tmp_path), "test", n=2, seed=1)
    capsys.readouterr()
    metrics = evaluate_folder("m", work_root=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    note = out.index("records vgg_random_fallback=true")
    assert out.index("RANDOM* VGG FEATURES", note) > note
    assert all(np.isfinite(v) for v in metrics.values())


def test_debug_nans_and_profile_dir_are_not_ignored(capsys):
    cfg = config_from_args(["--debug_nans", "--profile_dir", "p",
                            "--lane_pack"])
    note = capsys.readouterr().out
    assert "--lane_pack" in note
    assert "--debug_nans" not in note and "--profile_dir" not in note
    assert cfg.debug_nans and cfg.profile_dir == "p"
