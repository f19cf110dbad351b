"""The port's tensor parallelism (``tactile_gan_torch/parallel/
tensor_parallel.py``) on the CPU over gloo: which convs are split and how
the Adam moments follow, one step at 1 x 2 and 2 x 2 (data x model) held
to the JAX package's single-device step (``tests/test_sharding.py`` holds
the JAX TP step to the same kind of step), a gather whose backward sums
fails, the trainer's final_model.pth under a model axis read by the JAX
package and by the port, and ``dryrun_multichip(4, device="cpu")``."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tactile_gan_tpu.models import UNetPlusPlus as JaxUNetPlusPlus
from tactile_gan_tpu.utils import checkpoint as jax_checkpoint

from tactile_gan_torch.cli import train as port_cli
from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.entry import dryrun_multichip
from tactile_gan_torch.eval.runner import load_model
from tactile_gan_torch.models.blocks import init_weights
from tactile_gan_torch.models.factory import networks
from tactile_gan_torch.parallel.mesh import Mesh
from tactile_gan_torch.parallel.tensor_parallel import (
    shard_state_tp, split_layers,
)
from tactile_gan_torch.train.state import TrainState, make_optimizer
from tactile_gan_torch.train.step import build_train_step
from tactile_gan_torch.utils.checkpoint import load_checkpoint

import torch_dist as td

torch.set_num_threads(2)


@pytest.mark.parametrize("gen,min_features,split", [
    ("UNet++", 64, {"conv3_0.layer.0", "conv3_0.layer.3", "conv3_1.layer.0",
                    "conv3_1.layer.3", "conv4_0.layer.0", "conv4_0.layer.3",
                    "disc model.8"}),
    ("BCDUNet", 32, {"conv3.0", "conv3.3", "conv4.0", "conv4.3",
                     "upconv3", "conv3m.0", "conv3m.3", "disc model.5",
                     "disc model.8"}),
])
def test_shard_state_tp_splits_the_wide_convs(gen, min_features, split):
    """Every conv and transposed conv with at least ``min_features``
    output channels keeps rank 1's half of its weight (OIHW dim 0, IOHW
    dim 1) and bias, and Adam its half of their moments."""
    cfg = TrainConfig(gen=gen, nf=8, image_size=32, batch_size=2,
                      compute_dtype="float32", lambda_per=0, device="cpu")
    g, d = networks(cfg)
    init_weights(g, torch.Generator().manual_seed(0))
    init_weights(d, torch.Generator().manual_seed(1))
    state = TrainState(g, d, make_optimizer(g.parameters(), 1e-3, 0.9),
                       make_optimizer(d.parameters(), 1e-3, 0.9))
    batch = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    build_train_step(cfg, lambda s: 1e-3)(state, batch, batch, apply_gp=True,
                                          generator=torch.Generator())
    full = {n: (p.detach().clone(), {k: v.clone() for k, v in opt.state[p]
                                     .items()})
            for model, opt, pre in ((g, state.opt_g, ""),
                                    (d, state.opt_d, "disc "))
            for n, p in ((pre + n, p) for n, p in model.named_parameters())}
    shard_state_tp(Mesh(1, 2, 1, "gloo"), state, min_features)
    assert set(split_layers(g)) | {f"disc {n}" for n in split_layers(d)} \
        == split
    for model, opt, pre in ((g, state.opt_g, ""), (d, state.opt_d, "disc ")):
        params = [p for group in opt.param_groups for p in group["params"]]
        assert [id(p) for p in params] == [id(p) for p in model.parameters()]
        for name, p in model.named_parameters():
            layer = model.get_submodule(name.rpartition(".")[0])
            want, moments = full[pre + name]
            if pre + name.rpartition(".")[0] in split:
                dim = (1 if isinstance(layer, torch.nn.ConvTranspose2d)
                       and name.endswith("weight") else 0)
                c = want.shape[dim] // 2
                want = want.narrow(dim, c, c)
                moments = {k: v.narrow(dim, c, c) if v.dim() else v
                           for k, v in moments.items()}
                assert p.tp_shard.index == 1 and p.tp_shard.size == 2
            assert torch.equal(p, want), name
            for k, v in moments.items():
                assert torch.equal(opt.state[p][k], v), (name, k)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "jax_step.npz")
    td.jax_step_reference(path)
    return path


@pytest.fixture(scope="module")
def tp_runs(jax_ref, tmp_path_factory):
    """The step at 1 x 2, with a summing gather backward at 1 x 2, and at
    2 x 2."""
    root = str(tmp_path_factory.mktemp("tp"))
    td.spawn(td.step_rank, 2, root, jax_ref, 2,
             [("tp", None), ("tp_fault", "summing_gather")])
    td.spawn(td.step_rank, 4, root, jax_ref, 2, [("tp2x2", None)])
    out = {tag: torch.load(os.path.join(root, f"{tag}.pt"))
           for tag in ("tp", "tp_fault", "tp2x2")}
    for tag, world in (("tp", 2), ("tp2x2", 4)):
        out[tag]["ranks"] = [torch.load(os.path.join(
            root, f"{tag}_rank{r}.pt")) for r in range(world)]
    return out


def test_tp_splits_what_the_jax_package_splits(jax_ref, tp_runs):
    """The JAX package's ``shard_state_tp`` splits each 4-D kernel with at
    least ``min_features`` output channels: the same layers here."""
    ref = np.load(jax_ref)
    want = sorted(k.split("/", 1)[1].rpartition(".")[0] for k in ref
                  if k.startswith(("gen/", "disc/")) and ref[k].ndim == 4
                  and ref[k].shape[0] >= td.MIN_FEATURES)
    assert tp_runs["tp"]["split"] == want == tp_runs["tp2x2"]["split"]


@pytest.mark.parametrize("tag", ["tp", "tp2x2"])
def test_tp_step_matches_jax(jax_ref, tp_runs, tag):
    td.check_against_jax(tp_runs[tag], dict(np.load(jax_ref)))


@pytest.mark.parametrize("tag", ["tp", "tp2x2"])
def test_tp_ranks_compute_the_same_unsplit_gradients(tp_runs, tag):
    """The ranks of a model group compute the gradients of the parameters
    that are not split from the same gathered activations: before the
    average, each rank's (D's, then G's) holds the bits of its group's
    first rank (one thread a rank), and every rank reports rank 0's
    losses (averaged over the data group only)."""
    ranks = tp_runs[tag]["ranks"]
    for r, got in enumerate(ranks):
        first = ranks[r - r % 2]  # the model group's first rank (n_model 2)
        assert len(got["raw"]) == 2 and got["raw"][0].numel() > 0
        assert all(torch.equal(a, b) for a, b in zip(got["raw"],
                                                      first["raw"]))
        assert torch.equal(got["losses"], ranks[0]["losses"])


def test_tp_with_a_summing_gather_backward_fails(jax_ref, tp_runs):
    """The planted fault: the gather's backward sums over the model group
    (``torch.distributed.nn``'s all-gather), doubling every gradient that
    flows back through a split conv."""
    with pytest.raises(AssertionError):
        td.check_against_jax(tp_runs["tp_fault"], dict(np.load(jax_ref)))


def test_tp_final_model_loads_in_jax_and_the_port(tmp_path):
    """cli.train at --mesh_model 2 (UNet++ nf 16: its 256-channel convs
    split) writes final_model.pth at full shape, Adam moments included,
    close to the one-process run's; the JAX package's load_checkpoint and
    the port's load_model read it and give the same forward."""
    root = str(tmp_path)
    data = td.write_pairs(root, 2, 32)
    argv = ["--data", data, "--nf", "16", "--image_size", "32",
            "--batch_size", "2", "--total_epochs", "1", "--lambda_per", "0",
            "--compute_dtype", "float32", "--threads", "1", "--device", "cpu"]
    td.spawn(td.cli_rank, 2, root, argv + ["--mesh_model", "2",
                                          "--folder_save", "tp"], "tp")
    one = port_cli.main(argv + ["--folder_save", "one"])
    path = os.path.join(root, "models", "tp", "final_model.pth")
    ours, single = load_checkpoint(path), load_checkpoint(
        os.path.join(root, "models", "one", "final_model.pth"))
    assert ours["step"] == single["step"] == 1
    for key in ("gen", "disc"):
        assert {k: v.shape for k, v in ours[key].items()} == {
            k: v.shape for k, v in single[key].items()}
        td.assert_updates_close(
            torch.cat([ours[key][k].flatten() for k in sorted(ours[key])]),
            torch.cat([single[key][k].flatten() for k in sorted(ours[key])]),
            key)
    for key in ("optimizerG_state_dict", "optimizerD_state_dict"):
        for i, st in single[key]["state"].items():
            for k, v in st.items():
                assert ours[key]["state"][i][k].shape == v.shape
    assert ours["gen"]["conv4_0.layer.0.weight"].shape[0] == 256
    theirs = jax_checkpoint.load_checkpoint(path)
    gen, _ = load_model(path, one.cfg, device="cpu")
    x = np.random.default_rng(3).uniform(-1, 1, (1, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = gen(torch.from_numpy(x)).numpy()
    want = JaxUNetPlusPlus(output_dim=3, nf=16).apply(
        {"params": theirs["gen"]["params"]}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5)


def test_dryrun_multichip_on_the_cpu(capfd):
    """Both phases over 4 ranks: a 2 x 2 mesh with --version 2, then 4 x 1
    in bf16; rank 0 prints the transport and the JAX function's two
    lines."""
    dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip(4): gloo over 4 ranks, all on cpu" in out
    assert "dryrun_multichip(4): ok — mesh 2x2 (data x model) — G=" in out
    assert "dryrun_multichip(4): kernels-under-mesh ok — mesh 4x1 — G=" in out
