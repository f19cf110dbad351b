"""The port's serving path against the JAX package: the u8 quantize, the
metric sums, the copied host modules, the whole test.py flow on one model
folder, the import guard and the device policy."""

import ast
import json
import os
import pathlib
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from tactile_gan_tpu.data import dataset as jax_dataset
from tactile_gan_tpu.data import pairing as jax_pairing
from tactile_gan_tpu.eval import metrics as jax_metrics
from tactile_gan_tpu.eval import runner as jax_runner
from tactile_gan_tpu.eval import visualize as jax_visualize

from tactile_gan_torch.cli import test as port_cli
from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.core.device import resolve_device
from tactile_gan_torch.data import dataset as port_dataset
from tactile_gan_torch.data import pairing as port_pairing
from tactile_gan_torch.eval import metrics as port_metrics
from tactile_gan_torch.eval import runner as port_runner
from tactile_gan_torch.eval import visualize as port_visualize
from tactile_gan_torch.models.blocks import init_weights
from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus
from tactile_gan_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Device stages.
# ---------------------------------------------------------------------------

def _quantize_cases() -> np.ndarray:
    rng = np.random.default_rng(7)
    cases = [rng.uniform(-0.1, 1.1, 100_000).astype(np.float32)]
    # every half-integer boundary k + 0.5 of the 255 scale, +/- 4 f32 ulps
    bounds = ((np.arange(255, dtype=np.float64) + 0.5) / 255.0).astype(np.float32)
    for steps in range(-4, 5):
        b = bounds.copy()
        for _ in range(abs(steps)):
            b = np.nextafter(b, np.float32(2.0 if steps > 0 else -2.0))
        cases.append(b)
    # every k/255 itself, +/- 1 ulp
    exact = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)
    cases += [exact, np.nextafter(exact, np.float32(2.0)),
              np.nextafter(exact, np.float32(-2.0))]
    cases.append(np.array([0.5, 0.0, 1.0, -1.0, 2.0], np.float32))
    return np.concatenate(cases)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_u8_is_bit_exact(dtype):
    x = _quantize_cases()
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    ours = port_runner.quantize_u8(
        torch.from_numpy(x).to(getattr(torch, dtype))).numpy()
    np.testing.assert_array_equal(ours, jax_visualize._u8(x))
    np.testing.assert_array_equal(
        ours, np.asarray(jax_runner._quantize_u8(jnp.asarray(x, jnp.dtype(dtype)))))
    np.testing.assert_array_equal(ours, port_visualize._u8(x))


def test_fuzzy_sums_match_eval_pair():
    rng = np.random.default_rng(11)
    out = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    tgt = rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    sums = port_runner.fuzzy_sums(torch.from_numpy(out),
                                  torch.from_numpy(tgt)).numpy()
    assert sums.dtype == np.float64
    for k in range(3):
        want = jax_metrics.eval_pair(tgt[k].astype(np.float32) / 255.0, out[k])
        got = port_runner.metrics_from_sums(sums[k])
        for name in ("accuracy", "dice", "jaccard"):
            # float64 sums on both sides, in another order.
            np.testing.assert_allclose(got[name], want[name], rtol=1e-12)


def test_normalize_matches_jax_preprocessing():
    src = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1)
    want = np.asarray(jnp.asarray(src).astype(jnp.float32) / 255.0 * 2.0 - 1.0)
    np.testing.assert_array_equal(
        port_runner.normalize_u8(torch.from_numpy(src)).numpy(), want)


# ---------------------------------------------------------------------------
# Copied host modules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fuzzy,thresh", [(True, None), (False, 0.4),
                                          (False, "otsu"), (False, None)])
def test_metrics_copy_matches(fuzzy, thresh):
    rng = np.random.default_rng(23)
    r = rng.uniform(size=(3, 16, 16)).astype(np.float32)
    o = rng.uniform(size=(3, 16, 16)).astype(np.float32)
    assert (port_metrics.eval_pair(r, o, thresh=thresh, fuzzy=fuzzy)
            == jax_metrics.eval_pair(r, o, thresh=thresh, fuzzy=fuzzy))


def test_visualize_copy_matches():
    rng = np.random.default_rng(29)
    img = rng.uniform(-0.2, 1.2, (8, 12, 3)).astype(np.float32)
    for fn in ("to_pil", "compose_channels"):
        a = getattr(port_visualize, fn)(img)
        b = getattr(jax_visualize, fn)(img)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for mode in ("h", "v"):
        a = port_visualize.concat_images(port_visualize.to_pil(img),
                                         port_visualize.to_pil(img[::-1]), mode=mode)
        b = jax_visualize.concat_images(jax_visualize.to_pil(img),
                                        jax_visualize.to_pil(img[::-1]), mode=mode)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("target", ["rgb", "ch"])
def test_pairing_and_dataset_copies_match(tmp_path, target):
    root = _write_pairs(str(tmp_path), n=3, size=16, target=target)
    src_dir = os.path.join(root, "test", "source")
    assert port_pairing.list_images(src_dir) == jax_pairing.list_images(src_dir)
    for path in port_pairing.list_images(src_dir):
        assert (port_pairing.tactile_paths_for(path, target)
                == jax_pairing.tactile_paths_for(path, target))
    ours = port_dataset.PairedDataset(src_dir, size=16, target=target)
    theirs = jax_dataset.PairedDataset(src_dir, size=16, mode="test",
                                       target=target)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        for a, b in zip(ours.load_pair(i), theirs.load_pair(i)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        port_pairing.list_images(os.path.join(root, "missing"))


# ---------------------------------------------------------------------------
# The whole test.py flow on one model folder.
# ---------------------------------------------------------------------------

def _chart(rng, size):
    """A chart-like source (white page, black axes, coloured bars) and its
    tactile target (the same strokes in black on white)."""
    src = np.full((size, size, 3), 255, np.uint8)
    tac = np.full((size, size, 3), 255, np.uint8)
    base, left = size - 3, 2
    for img in (src, tac):
        img[base, left:] = 0
        img[:base + 1, left] = 0
    for j in range(left + 2, size - 2, 4):
        top = int(rng.integers(2, base - 1))
        colour = rng.integers(0, 200, 3).astype(np.uint8)
        src[top:base, j:j + 2] = colour
        tac[top:base, j:j + 2] = 0
    return src, tac


def _write_pairs(root, n, size, target="rgb", seed=0):
    rng = np.random.default_rng(seed)
    src_dir = os.path.join(root, "test", "source")
    tac_dir = os.path.join(root, "test", "tactile")
    os.makedirs(src_dir, exist_ok=True)
    os.makedirs(tac_dir, exist_ok=True)
    for i in range(n):
        src, tac = _chart(rng, size)
        Image.fromarray(src).save(os.path.join(src_dir, f"s_{i:04d}.png"))
        if target == "rgb":
            Image.fromarray(tac).save(os.path.join(tac_dir, f"t_{i:04d}.tiff"))
        else:
            for c, comp in enumerate(("axes", "grids", "content")):
                Image.fromarray(tac[:, :, c]).save(
                    os.path.join(tac_dir, f"t_{i:04d}_{comp}.tiff"))
    return root


def _write_model_folder(work_root, nf=8, size=32, n=5):
    cfg = TrainConfig(data="data", nf=nf, image_size=size, total_epochs=3,
                      compute_dtype="float32", folder_save="m",
                      folder_load="m", threads=2)
    model_dir = os.path.join(work_root, "models", "m")
    os.makedirs(model_dir)
    cfg.save_params(model_dir)
    gen = UNetPlusPlus(nf=nf)
    init_weights(gen, torch.Generator().manual_seed(3))
    save_checkpoint(os.path.join(model_dir, "final_model.pth"),
                    gen=gen.state_dict())
    for k in ("gen", "disc", "l1", "gp", "per"):
        np.save(os.path.join(model_dir, f"{k}loss.npy"),
                np.linspace(1.0, 0.5, 3).astype(np.float32))
    _write_pairs(os.path.join(work_root, "data"), n=n, size=size)
    return cfg


def _pngs(out_dir):
    names = sorted(os.listdir(os.path.join(out_dir, "out")))
    return {n: np.asarray(Image.open(os.path.join(out_dir, "out", n)))
            for n in names}


def test_evaluate_folder_matches_jax(tmp_path):
    roots = {k: os.path.join(str(tmp_path), k) for k in ("jax", "b1", "b4")}
    _write_model_folder(roots["jax"])
    for k in ("b1", "b4"):
        shutil.copytree(roots["jax"], roots[k])

    want = jax_runner.evaluate_folder("m", work_root=roots["jax"],
                                      eval_batch=1)
    got = port_runner.evaluate_folder("m", work_root=roots["b1"],
                                      eval_batch=1, device="cpu")
    got4 = port_cli.main(["--folder", "m", "--work_root", roots["b4"],
                          "--eval_batch", "4", "--device", "cpu"])

    outs = {k: os.path.join(r, "Outputs", "m") for k, r in roots.items()}
    for k in roots:
        for name in ("eval.txt", "loss.png", "accuracy_dist.png",
                     "dice_dist.png", "jaccard_dist.png"):
            assert os.path.exists(os.path.join(outs[k], name)), (k, name)
        assert len(os.listdir(os.path.join(outs[k], "sgt"))) == 5
    # float32 compute: the outputs agree to ~1e-6; JAX sums the metrics in
    # float32 on the device, the port in float64.
    for name in ("accuracy", "dice", "jaccard"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5)
        # eval_batch 4 (with a padded tail): the CPU library conv blocks a
        # batch of 4 differently, which moves the float32 outputs by ulps.
        np.testing.assert_allclose(got4[name], got[name], rtol=1e-5)
    jax_png, b1_png, b4_png = (_pngs(outs[k]) for k in ("jax", "b1", "b4"))
    assert sorted(jax_png) == sorted(b1_png) == [f"{i}.png" for i in range(1, 6)]
    for name in jax_png:
        a = jax_png[name].astype(np.int16)
        b = b1_png[name].astype(np.int16)
        assert np.abs(a - b).max() <= 1
        assert (a == b).mean() >= 0.999
        # eval_batch 4 (with a padded tail) gives the same artifacts
        np.testing.assert_array_equal(b1_png[name], b4_png[name])


def test_evaluate_folder_without_matplotlib_skips_only_the_plots(
        tmp_path, monkeypatch, capsys):
    root = str(tmp_path)
    _write_model_folder(root, n=2)
    monkeypatch.setattr(port_runner, "can_plot", lambda: False)
    got = port_runner.evaluate_folder("m", work_root=root, eval_batch=2,
                                      device="cpu")
    assert "matplotlib is not installed" in capsys.readouterr().out
    out = os.path.join(root, "Outputs", "m")
    assert sorted(os.listdir(out)) == ["elm", "eval.txt", "out", "sgt"]
    assert sorted(os.listdir(os.path.join(out, "out"))) == ["1.png", "2.png"]
    assert all(np.isfinite(v) for v in got.values())


def test_eval_transfer_modes_agree(tmp_path):
    root = str(tmp_path)
    cfg = _write_model_folder(root, n=3)
    forward, _ = port_runner.load_model(
        os.path.join(root, "models", "m", "final_model.pth"), cfg,
        device="cpu")
    ds = port_dataset.PairedDataset(os.path.join(root, "data", "test", "source"))
    res = {t: port_runner.test_model(forward, ds, os.path.join(root, t),
                                     evaluation=True, eval_batch=2, threads=2,
                                     transfer=t) for t in ("u8", "f32")}
    for a, b in zip(res["u8"], res["f32"]):
        np.testing.assert_allclose(a, b, rtol=1e-12)  # float64 both ways
    for t in ("u8", "f32"):
        assert sorted(os.listdir(os.path.join(root, t, "out"))) == [
            "1.png", "2.png", "3.png"]
    for name in ("1.png", "2.png", "3.png"):
        a = open(os.path.join(root, "u8", "out", name), "rb").read()
        assert a == open(os.path.join(root, "f32", "out", name), "rb").read()
    with pytest.raises(ValueError):
        port_runner.test_model(forward, ds, root, transfer="f16")


def test_params_file_round_trips_through_jax_config(tmp_path):
    from tactile_gan_tpu.core.config import TrainConfig as JaxTrainConfig

    cfg = TrainConfig(nf=16, loss="hinge", compute_dtype="float32")
    cfg.save_params(str(tmp_path))
    path = os.path.join(str(tmp_path), "params.txt")
    theirs = JaxTrainConfig.from_params_file(path)
    ours = TrainConfig.from_params_file(path)
    assert ours == cfg
    assert (theirs.nf, theirs.loss, theirs.compute_dtype) == (16, "hinge", "float32")
    assert ours.activation is False and theirs.activation is False
    # A params.txt of the JAX package (extra keys) loads too.
    JaxTrainConfig(nf=8, target="ch").save_params(str(tmp_path))
    assert TrainConfig.from_params_file(path).target == "ch"
    with open(path) as f:
        assert "use_pallas" in json.load(f)


# ---------------------------------------------------------------------------
# Import guard and device policy.
# ---------------------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tactile_gan_tpu")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "tactile_gan_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_default_device_is_cuda_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    cfg = _write_model_folder(str(tmp_path), n=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_runner.load_model(
            os.path.join(str(tmp_path), "models", "m", "final_model.pth"), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["--folder", "m", "--work_root", str(tmp_path)])
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_profile_breakdown_sorts_kernels_into_families():
    from tactile_gan_torch.utils import profiling

    names = {"void (anonymous namespace)::in_act_fwd_kernel<float>(...)":
                 "kernel_a",
             "void (anonymous namespace)::in_act_fwd_kernel<__nv_bfloat16>(...)":
                 "kernel_a",
             "void (anonymous namespace)::conv3x3_fwd_sm90_kernel<float, 64>(...)":
                 "kernel_b",
             "sm90_xmma_fprop_implicit_gemm_bf16bf16": "library_conv",
             "void at::native::elementwise_kernel<128, 4>(...)": "other"}
    for name, family in names.items():
        assert profiling.kernel_family(name) == family
    # Overlapping intervals count once: [0, 4) and [6, 10) are busy.
    assert profiling.busy_us([(0, 3), (1, 4), (6, 10), (7, 8)]) == 8
    kernels = [("in_act_fwd_kernel", 0, 2), ("conv3x3_f32_kernel", 2, 6),
               ("in_act_fwd_kernel", 10, 12), ("conv3x3_f32_kernel", 12, 16)]
    res = profiling.breakdown(kernels, window_us=20, reps=2)
    assert res["device_ms"] == {"kernel_a": 2e-3, "kernel_b": 4e-3}
    assert res["launches"] == {"kernel_a": 1, "kernel_b": 1}
    assert res["idle_share"] == pytest.approx(0.4)
    assert res["top_kernels_ms"] == [["conv3x3_f32_kernel", 4e-3],
                                     ["in_act_fwd_kernel", 2e-3]]
    assert profiling.breakdown([], 10, 1)["idle_share"] == "not measured"
