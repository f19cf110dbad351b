"""Two-step eval (stage 1 source -> RGB tactile, stage 2 RGB -> the
channel-wise components) against the JAX package's ``test_two_step`` on a
64x64 folder, ``cli.two_step_test`` end to end, and the chain's device
rule."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from tactile_gan_tpu.data.dataset import PairedDataset as JaxPairedDataset
from tactile_gan_tpu.eval import runner as jax_runner

from test_torch_eval import _write_pairs

from tactile_gan_torch.cli import two_step_test as two_step_cli
from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.data.dataset import PairedDataset
from tactile_gan_torch.eval import runner
from tactile_gan_torch.models.blocks import init_weights
from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus
from tactile_gan_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(2)

SIZE, NF, N = 64, 4, 3


def _stage(root, folder, target, seed):
    """A seeded UNet++ model folder with its params.txt."""
    cfg = TrainConfig(data="data", nf=NF, image_size=SIZE, target=target,
                      compute_dtype="float32", folder_save=folder,
                      folder_load=folder, threads=2)
    model_dir = os.path.join(root, "models", folder)
    os.makedirs(model_dir)
    cfg.save_params(model_dir)
    gen = UNetPlusPlus(nf=NF)
    init_weights(gen, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # norms off (1, 0), so the chain is not flat
        g = torch.Generator().manual_seed(seed + 1)
        for name, p in gen.named_parameters():
            if p.dim() == 1:
                p.add_(0.3 * torch.randn(p.shape, generator=g))
    save_checkpoint(os.path.join(model_dir, "final_model.pth"),
                    gen=gen.state_dict())
    return cfg


@pytest.fixture(scope="module")
def two_step_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("two_step"))
    _stage(root, "s1", "rgb", 3)
    _stage(root, "s2", "ch", 5)
    _write_pairs(os.path.join(root, "charts"), n=N, size=SIZE, target="ch",
                 seed=2)
    return root


def _pngs(out_dir, sub):
    return {n: np.asarray(Image.open(os.path.join(out_dir, sub, n)))
            for n in sorted(os.listdir(os.path.join(out_dir, sub)))}


def _load(root, folder, load):
    cfg = TrainConfig.from_params_file(os.path.join(root, "models", folder,
                                                    "params.txt"))
    path = os.path.join(root, "models", folder, "final_model.pth")
    return load(path, cfg)


def test_two_step_chain_matches_jax(two_step_root):
    root = two_step_root
    src = os.path.join(root, "charts", "test", "source")
    out = {k: os.path.join(root, "out_" + k) for k in ("jax", "port")}
    jf = [_load(root, s, lambda p, c: jax_runner.load_model(p, c)[0])
          for s in ("s1", "s2")]
    want = jax_runner.test_two_step(
        jf[0], jf[1], JaxPairedDataset(src, size=SIZE, mode="test",
                                       target="ch"),
        out["jax"], evaluation=True, threads=2)
    pf = [_load(root, s, lambda p, c: runner.load_model(p, c,
                                                        device="cpu")[0])
          for s in ("s1", "s2")]
    got = runner.test_two_step(pf[0], pf[1], PairedDataset(
        src, size=SIZE, mode="test", target="ch"), out["port"],
        evaluation=True, threads=2)
    assert len(got[0]) == len(want[0]) == N
    for a, b in zip(got, want):  # accuracy, dice, jaccard per image
        np.testing.assert_allclose(a, b, rtol=1e-4)
    for sub in ("out", "sgt", "elm"):
        theirs, ours = _pngs(out["jax"], sub), _pngs(out["port"], sub)
        assert sorted(ours) == sorted(theirs) == [f"{i}.png"
                                                  for i in range(1, N + 1)]
        for name in ours:
            a = ours[name].astype(np.int16)
            b = theirs[name].astype(np.int16)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1, (sub, name)
            assert (a == b).mean() >= 0.999, (sub, name)


def test_two_step_cli_writes_every_artifact(two_step_root, capsys):
    root = two_step_root
    res = two_step_cli.main(["--s1_dir", "s1", "--s2_dir", "s2", "--data",
                             "charts", "--work_root", root, "--eval_batch",
                             "2", "--device", "cpu"])
    assert "Dice" in capsys.readouterr().out
    out = os.path.join(root, "Outputs", "s1+s2_charts")
    assert {"out", "sgt", "elm", "eval.txt"} <= set(os.listdir(out))
    for sub in ("out", "sgt", "elm"):
        assert len(os.listdir(os.path.join(out, sub))) == N
    assert all(len(v) == N and np.all(np.isfinite(v)) for v in res)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            two_step_cli.main(["--s1_dir", "s1", "--s2_dir", "s2",
                               "--data", "charts", "--work_root", root])


def test_chain_refuses_two_devices():
    gen = UNetPlusPlus(nf=NF)
    cpu = runner.GeneratorForward(gen, torch.device("cpu"))
    other = runner.GeneratorForward(gen, torch.device("cuda"))
    with pytest.raises(ValueError, match="one device"):
        runner.ChainedForward(cpu, other)
    chain = runner.ChainedForward(cpu, cpu)
    x = torch.zeros(1, 16, 16, 3)
    assert chain.device == torch.device("cpu")
    torch.testing.assert_close(chain(x), cpu(cpu(x)), rtol=0, atol=0)
