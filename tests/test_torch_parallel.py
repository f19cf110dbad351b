"""The port's data parallelism (``tactile_gan_torch/parallel/mesh.py``, the
data-parallel step of ``train/step.py``, ``batches(local_rows=...)``) on
the CPU over gloo: the launch environment and the mesh arithmetic, the
ranks' batch rows against the JAX loader's, and one step over 2 ranks held
to the JAX package's single-device step (``tests/test_sharding.py`` holds
the JAX mesh steps to the same step) and to the port's own one-process
step; a rank that leaves D's gradients out of the average fails."""

import os

import numpy as np
import pytest
import torch

from tactile_gan_tpu.data import dataset as jax_dataset

from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.data import dataset as port_dataset
from tactile_gan_torch.parallel.mesh import (
    Mesh, choose_backend, grid_groups, local_batch_rows,
    maybe_init_distributed, rank_device,
)
from tactile_gan_torch.train.loop import Trainer

import torch_dist as td

torch.set_num_threads(2)


def test_maybe_init_distributed_env_validation(monkeypatch):
    """A partial torchrun environment, or ranks that are not integers,
    raise: running on as independent trainers would corrupt the
    artifacts (the JAX package's test of the same name)."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_init_distributed("cpu") is False  # no env: a no-op
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="are required"):
        maybe_init_distributed("cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "two")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="must be integers"):
        maybe_init_distributed("cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,backend,ranks,want", [
    ("cpu", None, 4, "gloo"),
    ("cuda:0", "gloo", 4, "gloo"),
    ("cpu", "nccl", 1, "nccl needs a CUDA device"),
    ("cuda:0", "nccl", 2, "shared by all 2 ranks"),
    ("cuda", "nccl", 64, "NCCL needs one card a rank"),
])
def test_choose_backend(device, backend, ranks, want):
    """nccl on cards, gloo on the CPU; ranks sharing a card must ask for
    gloo, and nccl with more ranks than cards is refused before NCCL
    sees it."""
    if want in ("gloo", "nccl"):
        assert choose_backend(device, backend, ranks) == want
    else:
        with pytest.raises(ValueError, match=want):
            choose_backend(device, backend, ranks)


def test_rank_device():
    assert rank_device("cuda", 3) == torch.device("cuda", 3)
    assert rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert rank_device("cpu", 3) == torch.device("cpu")


@pytest.mark.parametrize("n_data,n_model", [(4, 1), (2, 2), (1, 4), (3, 2)])
def test_mesh_grid_is_the_jax_reshape(n_data, n_model):
    """Rank r sits at (r // n_model, r % n_model), as the JAX package's
    ``reshape(n_data, n_model)`` of its devices; its data group splits the
    batch, its model group the wide convs."""
    grid = np.arange(n_data * n_model).reshape(n_data, n_model)
    data, model = grid_groups(n_data, n_model)
    assert data == [list(grid[:, m]) for m in range(n_model)]
    assert model == [list(grid[d]) for d in range(n_data)]
    for r in range(n_data * n_model):
        mesh = Mesh(n_data, n_model, r, "gloo")
        assert grid[mesh.data_index, mesh.model_index] == r
        assert mesh.shape == {"data": n_data, "model": n_model}


@pytest.mark.parametrize("batch,n_data,rank,n_model,want", [
    (8, 4, 5, 2, slice(4, 6)), (4, 2, 1, 1, slice(2, 4)),
    (4, 1, 1, 2, slice(0, 4)), (6, 3, 0, 1, slice(0, 2))])
def test_local_batch_rows(batch, n_data, rank, n_model, want):
    assert local_batch_rows(batch, Mesh(n_data, n_model, rank, "gloo")) == want


def test_local_batch_rows_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="divide evenly"):
        local_batch_rows(6, Mesh(4, 1, 0, "gloo"))


@pytest.mark.parametrize("drop_last,pad", [(True, False), (False, True)])
def test_local_rows_are_the_jax_loaders(tmp_path, drop_last, pad):
    """Each rank's rows of every batch, augmentation included, byte-equal
    to the JAX loader's ``local_rows`` and to those rows of the whole
    batch."""
    src_dir = os.path.join(td.write_pairs(str(tmp_path), 7, 16), "train",
                           "source")
    ours = port_dataset.PairedDataset(src_dir, size=16, mode="train", aug=True)
    theirs = jax_dataset.PairedDataset(src_dir, size=16, mode="train",
                                       aug=True)
    kw = dict(shuffle=True, seed=3, drop_last=drop_last, pad_to_batch=pad,
              threads=2, host_augment=True, augment_seed=9)
    whole = list(ours.batches(4, **kw))
    for rows in (slice(0, 2), slice(2, 4)):
        got = list(ours.batches(4, local_rows=rows, **kw))
        want = list(theirs.batches(4, local_rows=rows, **kw))
        assert len(got) == len(want) == len(whole) == (1 if drop_last else 2)
        for (s, t, v), (s2, t2, v2), (s3, t3, v3) in zip(got, want, whole):
            assert v == v2 == v3 and s.shape[0] == 2
            assert np.array_equal(s, s2) and np.array_equal(t, t2)
            assert np.array_equal(s, s3[rows]) and np.array_equal(t, t3[rows])


def test_trainer_mesh_validation(tmp_path):
    """An axis the world cannot hold raises a clear error (the JAX
    package's ``test_trainer_mesh_validation``)."""
    data = td.write_pairs(str(tmp_path), 2, 32)
    ds = port_dataset.PairedDataset(os.path.join(data, "train", "source"),
                                    mode="train")
    for kw, match in (({"mesh_model": 16}, "mesh_model 16 exceeds"),
                      ({"mesh_data": 2}, "must equal the world size 1")):
        cfg = TrainConfig(data=data, nf=4, image_size=32, batch_size=2,
                          device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            Trainer(cfg, ds)


# ---------------------------------------------------------------------------
# One step over the ranks against the JAX step and the port's own.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "jax_step.npz")
    td.jax_step_reference(path)
    return path


@pytest.fixture(scope="module")
def one_process(jax_ref):
    """The port's one-process step (no process group) on the reference,
    on one thread as the ranks run (the CPU library's sums follow the
    thread count)."""
    ref = dict(np.load(jax_ref))
    state = td.reference_state(ref)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses = td.reference_step(ref, state)
    finally:
        torch.set_num_threads(threads)
    return {"losses": losses, "gen": state.gen.state_dict(),
            "disc": state.disc.state_dict()}


@pytest.fixture(scope="module")
def dp_runs(jax_ref, tmp_path_factory):
    """The step over 2 ranks (2 x 1), as is and with D's gradients left out
    of the average."""
    root = str(tmp_path_factory.mktemp("dp"))
    td.spawn(td.step_rank, 2, root, jax_ref, 1,
             [("dp", None), ("dp_fault", "d_unreduced")])
    return {tag: torch.load(os.path.join(root, f"{tag}.pt"))
            for tag in ("dp", "dp_fault")}


def test_world_size_one_step_is_the_one_process_step(jax_ref, one_process,
                                                     tmp_path):
    """A one-rank mesh (its all-reduces included) gives the bits of the
    step without a process group."""
    td.spawn(td.step_rank, 1, str(tmp_path), jax_ref, 1, [("ws1", None)])
    got = torch.load(os.path.join(str(tmp_path), "ws1.pt"))
    assert torch.equal(got["losses"], one_process["losses"])
    for key in ("gen", "disc"):
        assert all(torch.equal(got[key][k], v)
                   for k, v in one_process[key].items())


def test_dp_step_matches_jax(jax_ref, dp_runs):
    td.check_against_jax(dp_runs["dp"], dict(np.load(jax_ref)))


def test_dp_step_matches_the_one_process_port_step(dp_runs, one_process):
    """Within float32 reduction noise: the losses to 1e-5, the updates
    with no element off by more than lr/10 in more than 0.1%."""
    got = dp_runs["dp"]
    np.testing.assert_allclose(got["losses"].numpy(),
                               one_process["losses"].numpy(), rtol=1e-5)
    for key in ("gen", "disc"):
        diff = torch.cat([(got[key][k] - v).abs().flatten()
                          for k, v in one_process[key].items()])
        assert diff.mean() < 1e-3 * td.LR, (key, diff.mean())
        assert (diff > 0.1 * td.LR).float().mean() < 1e-3, key


def test_dp_without_d_all_reduce_fails(jax_ref, dp_runs):
    """The planted fault: each rank updates D on its own rows only."""
    with pytest.raises(AssertionError):
        td.check_against_jax(dp_runs["dp_fault"], dict(np.load(jax_ref)))
