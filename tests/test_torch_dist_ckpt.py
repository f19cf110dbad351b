"""``--ckpt_backend orbax`` on ``torch.distributed.checkpoint``
(``tactile_gan_torch/utils/dist_ckpt.py``) and the trainer over 2 processes
on the CPU (gloo): a save under 1 x 2 tensor parallelism restored bit for
bit, a half-written step directory skipped, a directory the JAX package's
orbax wrote refused, and ``cli.train`` end to end with both backends (the
JAX package's ``test_twohost_distributed_train``): only rank 0 prints and
writes, both ranks report the same losses, and the resume takes the
latest step."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tactile_gan_torch.models.blocks import init_weights
from tactile_gan_torch.models.factory import networks
from tactile_gan_torch.train.state import TrainState, make_optimizer
from tactile_gan_torch.train.step import build_train_step
from tactile_gan_torch.utils.dist_ckpt import DistCheckpointer, flat_state

import torch_dist as td

torch.set_num_threads(2)


def test_tp_checkpoint_restores_bit_for_bit(tmp_path):
    """Each rank of a 1 x 2 mesh saves its own slices (keys of their own)
    and the replicated tensors; a restore at the latest step into a freshly
    seeded sharded state gives back every tensor and the step."""
    root = str(tmp_path)
    td.spawn(td.ckpt_rank, 2, root)
    got = [json.load(open(os.path.join(root, f"ckpt_{r}.json")))
           for r in range(2)]
    for r, res in enumerate(got):
        assert res["equal"] and res["latest"] == res["step"] == 1, res
        assert res["split_keys"] and all(f"@shard{r}of2" in k
                                         for k in res["split_keys"])
    assert sorted(os.listdir(os.path.join(root, "orbax"))) == ["1"]


def _state(seed):
    cfg = td.port_config(lambda_per=0, nf=4)
    gen, disc = networks(cfg)
    init_weights(gen, torch.Generator().manual_seed(seed))
    init_weights(disc, torch.Generator().manual_seed(seed + 1))
    return cfg, TrainState(gen, disc,
                           make_optimizer(gen.parameters(), td.LR, td.BETA1),
                           make_optimizer(disc.parameters(), td.LR, td.BETA1))


def test_latest_step_skips_a_half_written_directory(tmp_path):
    """One process (no process group): step directories are written async
    and complete only with DCP's .metadata; a directory without it (a save
    cut off) is not a step, and the restore reads the latest whole one."""
    cfg, state = _state(1)
    batch = torch.zeros((4, 32, 32, 3), dtype=torch.uint8)
    build_train_step(cfg, td.schedule())(state, batch, batch, apply_gp=True,
                                         generator=torch.Generator())
    ck = DistCheckpointer(str(tmp_path / "orbax"))
    assert ck.latest_step() is None
    ck.save(state.step, state)
    ck.wait()
    half = tmp_path / "orbax" / "7"
    half.mkdir()
    (half / "__0_0.distcp").write_bytes(b"cut off")
    assert ck.latest_step() == 1
    _, fresh = _state(5)
    ck.restore(ck.latest_step(), fresh)
    ck.close()
    a, b = flat_state(state), flat_state(fresh)
    assert sorted(a) == sorted(b) and fresh.step == 1
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_directory_orbax_wrote_is_refused(tmp_path):
    """The port reads DCP, not orbax: resuming from the JAX package's
    orbax step directory raises rather than misreading it."""
    from tactile_gan_tpu.utils.orbax_ckpt import OrbaxBackend

    backend = OrbaxBackend(str(tmp_path / "orbax"))
    backend.save(3, {"w": jnp.ones((4,), jnp.float32)})
    backend.wait()
    backend.close()
    with pytest.raises(ValueError, match="written by orbax"):
        DistCheckpointer(str(tmp_path / "orbax")).latest_step()


def _read(root, tag):
    return [json.load(open(os.path.join(root, f"{tag}_{r}.json")))
            for r in range(2)]


@pytest.mark.parametrize("backend", ["native", "orbax"])
def test_two_process_cli_train(tmp_path, capfd, backend):
    """cli.train over 2 ranks (2 x 1) for two epochs of two steps, with a
    checkpoint every epoch: equal losses on both ranks, every artifact
    written, the epoch lines printed by rank 0 alone; with orbax the step
    directories 2 and 4, from which --continue_training resumes at step
    4."""
    root = str(tmp_path)
    data = td.write_pairs(root, 8, 32)
    argv = ["--data", data, "--nf", "4", "--image_size", "32",
            "--batch_size", "4", "--total_epochs", "2", "--lambda_per", "0",
            "--compute_dtype", "float32", "--threads", "1",
            "--folder_save", "mh", "--folder_load", "mh",
            "--checkpoint_interval", "1", "--seed", "5",
            "--ckpt_backend", backend, "--device", "cpu"]
    td.spawn(td.cli_rank, 2, root, argv, "run")
    out = capfd.readouterr().out
    ranks = _read(root, "run")
    assert [r["main"] for r in ranks] == [True, False]
    for r in ranks:
        assert r["mesh"] == {"data": 2, "model": 1} and r["step"] == 4
    for k in ("gen_loss", "disc_loss", "l1_loss"):
        assert len(ranks[0][k]) == 2
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    assert out.count("==training epoch") == 2
    assert out.count("saved model + arrays + params") == 1
    mdir = os.path.join(root, "models", "mh")
    assert sorted(os.listdir(mdir)) == sorted(
        ["final_model.pth", "params.txt"]
        + [f"{k}loss.npy" for k in ("gen", "disc", "l1", "per", "gp")])
    cdir = os.path.join(root, "checkpoints", "mh")
    if backend == "native":
        assert sorted(os.listdir(cdir)) == ["model_1.pth", "model_2.pth"]
        return
    assert sorted(os.listdir(os.path.join(cdir, "orbax"))) == ["2", "4"]
    for step in ("2", "4"):
        assert os.path.exists(os.path.join(cdir, "orbax", step, ".metadata"))
    td.spawn(td.cli_rank, 2, root, argv + ["--total_epochs", "1",
                                          "--continue_training"], "resume")
    for r in _read(root, "resume"):
        assert r["step_offset"] == 4 and r["step"] == 6, r
