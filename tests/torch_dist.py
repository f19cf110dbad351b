"""Helpers of the port's parallel tests (``tests/test_torch_parallel.py``,
``test_torch_tensor_parallel.py``, ``test_torch_dist_ckpt.py``).

Ranks are spawned with ``torch.multiprocessing`` and join a gloo group over
a ``FileStore`` in the test's temporary directory (no TCP port, so tests
side by side cannot collide); each rank runs one thread. The rank
functions live here, not in the test files, so a spawned rank imports
torch and the port but not JAX. ``jax_step_reference`` (the one JAX step
the parallel steps are held to) imports JAX where it is called.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

NF, SIZE, BATCH = 8, 32, 4
LR, BETA1 = 1e-3, 0.9
MIN_FEATURES = 64  # splits UNet++ rows 3-4 and D's widest conv at nf 8


def spawn(fn, world: int, root: str, *args) -> None:
    """Run ``fn(rank, world, root, *args)`` on ``world`` spawned ranks of a
    gloo group; raises if a rank fails."""
    import torch.multiprocessing as mp

    store = os.path.join(root, f"store_{fn.__name__}_{world}")
    if os.path.exists(store):
        os.remove(store)
    mp.start_processes(_rank, args=(fn, world, store, root, args),
                       nprocs=world, start_method="spawn")


def _rank(rank, fn, world, store, root, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, world, root, *args)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# One training step against the JAX package's.
# ---------------------------------------------------------------------------

def port_config(**kw):
    from tactile_gan_torch.core.config import TrainConfig

    fields = dict(nf=NF, batch_size=BATCH, image_size=SIZE,
                  compute_dtype="float32", lr=LR, beta1=BETA1, device="cpu")
    return TrainConfig(**{**fields, **kw})


def schedule():
    from tactile_gan_torch.train.schedule import multistep_lr

    return multistep_lr(LR, 25, 135, 100)


def jax_step_reference(path: str) -> None:
    """One jitted JAX single-device step (UNet++ nf 8, 32x32, batch 4,
    float32, GP, the v1 perceptual loss on the JAX fallback tower, label
    smoothing), written to ``path`` (npz) in the port's layout: the states
    before (``gen/*``, ``disc/*``) and after (``after_gen/*``,
    ``after_disc/*``), the losses, the batch, the step's own label noise
    and GP alpha (global draws) and the VGG tower (``vgg/*``)."""
    import jax
    import jax.numpy as jnp

    from tactile_gan_tpu.core.config import TrainConfig as JaxTrainConfig
    from tactile_gan_tpu.models import vgg as jax_vgg
    from tactile_gan_tpu.models.factory import (
        create_discriminator, create_generator,
    )
    from tactile_gan_tpu.train.schedule import multistep_lr
    from tactile_gan_tpu.train.state import create_train_state, make_optimizer
    from tactile_gan_tpu.train.step import build_train_step
    from tactile_gan_torch.utils.convert import (
        patchdisc_state_dict_from_jax, unetpp_state_dict_from_jax,
    )

    cfg = JaxTrainConfig(gen="UNet++", nf=NF, batch_size=BATCH,
                         image_size=SIZE, compute_dtype="float32", lr=LR,
                         beta1=BETA1)
    gen = create_generator("UNet++", 3, NF, activation=True)
    disc = create_discriminator("patch", NF, activation=True)
    sched = multistep_lr(LR, cfg.epoch_constant, cfg.total_epochs, 100)
    g_tx, d_tx = make_optimizer(sched, BETA1), make_optimizer(sched, BETA1)
    tower = jax_vgg.load_vgg_features("")
    ex = jnp.zeros((BATCH, SIZE, SIZE, 3))
    # Weights from numpy into the state's shapes (the modules' own inits
    # take 40 s op by op on this CPU, 11 s jitted): kernels and biases
    # N(0, 0.05), norm scales 1 + N(0, 0.05).
    shapes = jax.eval_shape(lambda k: create_train_state(
        gen, disc, ex, ex, k, g_tx, d_tx), jax.random.key(3))
    rng = np.random.default_rng(7)

    def draw(path, leaf):
        v = rng.normal(size=leaf.shape) * 0.05
        return jnp.asarray(v + (path[-1].key == "scale"), jnp.float32)

    g_params = jax.tree_util.tree_map_with_path(draw, shapes.g_params)
    d_params = jax.tree_util.tree_map_with_path(draw, shapes.d_params)
    state = shapes.replace(g_params=g_params, d_params=d_params,
                           g_opt_state=g_tx.init(g_params),
                           d_opt_state=d_tx.init(d_params),
                           step=jnp.zeros((), jnp.int32))
    step = build_train_step(cfg, gen, disc, g_tx, d_tx,
                            vgg_apply=jax_vgg.vgg_features_apply,
                            vgg_params=tower)
    rng = np.random.default_rng(41)
    src = rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), np.uint8)
    tgt = rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), np.uint8)
    key = jax.random.key(5)
    before = jax.tree.map(np.array, jax.device_get(state))  # step donates it
    after, m = step(state, jnp.asarray(src), jnp.asarray(tgt), key,
                    apply_gp=True)
    k_step = jax.random.fold_in(key, 0)
    pred_shape = (BATCH, 1, 1, 1)  # D's patch map at 32x32
    noise = jax.random.normal(jax.random.fold_in(k_step, 3), pred_shape,
                              jnp.float32)
    alpha = jax.random.uniform(jax.random.fold_in(k_step, 4),
                               (BATCH, 1, 1, 1), jnp.float32)
    out = {"losses": np.asarray([float(v) for v in (
        m.loss_d, m.loss_g, m.loss_l1, m.loss_gp, m.loss_per)], np.float32),
        "src": src, "tgt": tgt, "noise": np.asarray(noise),
        "alpha": np.asarray(alpha)}
    for prefix, host in (("", before), ("after_", jax.tree.map(
            np.array, jax.device_get(after)))):
        for key_, params, conv in (
                ("gen", host.g_params, unetpp_state_dict_from_jax),
                ("disc", host.d_params, patchdisc_state_dict_from_jax)):
            for k, v in conv(params).items():
                out[f"{prefix}{key_}/{k}"] = np.asarray(v)
    for k, v in tower.items():
        v = np.asarray(v)
        if k.endswith(".kernel"):
            out[f"vgg/{k.replace('.kernel', '.weight')}"] = \
                np.ascontiguousarray(v.transpose(3, 2, 0, 1))
        else:
            out[f"vgg/{k}"] = v
    np.savez(path, **out)


def _group(ref, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith(prefix)}


def reference_state(ref):
    """The port's TrainState from the reference's state before the step."""
    from tactile_gan_torch.models.patch_discriminator import (
        PatchDiscriminator,
    )
    from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus
    from tactile_gan_torch.train.state import TrainState, make_optimizer

    gen = UNetPlusPlus(nf=NF, compute_dtype=torch.float32)
    gen.load_state_dict(_group(ref, "gen/"))
    disc = PatchDiscriminator(nf=NF)
    disc.load_state_dict(_group(ref, "disc/"))
    return TrainState(gen, disc, make_optimizer(gen.parameters(), LR, BETA1),
                      make_optimizer(disc.parameters(), LR, BETA1))


def reference_step(ref, state, mesh=None, rows=slice(None)):
    """One port step on the reference's batch (this rank's ``rows``) and its
    global draws; the five losses."""
    from tactile_gan_torch.train.step import build_train_step

    step = build_train_step(port_config(), schedule(), _group(ref, "vgg/"),
                            mesh)
    return step(state, torch.from_numpy(ref["src"][rows]),
                torch.from_numpy(ref["tgt"][rows]), apply_gp=True,
                label_noise=torch.from_numpy(ref["noise"]),
                gp_alpha=torch.from_numpy(ref["alpha"]))


def plant(fault: str):
    """Plant ``fault`` in this process: ``d_unreduced`` (the step leaves
    D's gradients out of the data-group average) or ``summing_gather``
    (the channel gather's backward sums over the model group, as
    ``torch.distributed.nn``'s all-gather does). Returns the undo."""
    from tactile_gan_torch.parallel import tensor_parallel as tp
    from tactile_gan_torch.train import step as step_module

    if fault == "d_unreduced":
        orig, calls = step_module.TrainStep._reduce, [0]

        def reduce(self, params, grads):
            calls[0] += 1  # D's gradients, then G's: two a step
            return (list(grads) if calls[0] % 2 == 1
                    else orig(self, params, grads))
        step_module.TrainStep._reduce = reduce
        return lambda: setattr(step_module.TrainStep, "_reduce", orig)
    orig = tp.GatherChannels.__dict__["backward"]

    def summing(ctx, g):
        return (tp.SliceChannels.apply(
            tp.ReduceFromModel.apply(g, ctx.shard), ctx.shard), None)
    tp.GatherChannels.backward = staticmethod(summing)
    return lambda: setattr(tp.GatherChannels, "backward", orig)


def step_rank(rank, world, root, ref_path, n_model, runs):
    """For each (tag, fault or None) of ``runs``: one reference step from
    the reference's state on a ``world / n_model x n_model`` mesh (split
    at MIN_FEATURES); rank 0 writes the losses and the full state dicts to
    ``root/{tag}.pt``, and every rank its losses and the gradients it
    computed for the parameters that are not split, before the average
    (D's, then G's), to ``root/{tag}_rank{rank}.pt``."""
    from tactile_gan_torch.parallel.mesh import local_batch_rows, make_mesh
    from tactile_gan_torch.parallel.tensor_parallel import (
        full_state_dicts, shard_state_tp,
    )

    from tactile_gan_torch.parallel.rank_probe import unsplit_gradients

    ref = dict(np.load(ref_path))
    mesh = make_mesh(0, n_model)
    for tag, fault in runs:
        state = reference_state(ref)
        shard_state_tp(mesh, state, MIN_FEATURES)
        undo = plant(fault) if fault else None
        try:
            with unsplit_gradients() as raw:
                losses = reference_step(ref, state, mesh,
                                        local_batch_rows(BATCH, mesh))
        finally:
            if undo:
                undo()
        torch.save({"losses": losses, "raw": [
            torch.cat([g.flatten() for g in call]) for call in raw]},
            os.path.join(root, f"{tag}_rank{rank}.pt"))
        sd = full_state_dicts(state)
        if rank == 0:
            torch.save({"losses": losses, "gen": sd["gen"],
                        "disc": sd["disc"], "split": sorted(
                            n for m in (state.gen, state.disc)
                            for n, layer in m.named_modules()
                            if getattr(layer, "tp_shard", None) is not None),
                        "step": state.step},
                       os.path.join(root, f"{tag}.pt"))


def assert_updates_close(ours, theirs, label):
    """``tests/test_torch_train.py``'s statistical comparison of one Adam
    update: elements with a near-zero gradient may differ by up to 2 lr."""
    diff = np.abs(np.asarray(ours) - np.asarray(theirs))
    assert diff.mean() < 0.1 * LR, f"{label}: mean diff {diff.mean()}"
    frac_big = float((diff > 0.5 * LR).mean())
    assert frac_big < 0.05, f"{label}: {frac_big:.1%} elements off > lr/2"


def check_against_jax(result, ref):
    """A step's result held to the JAX step with ``tests/
    test_torch_train.py``'s ``_check_step`` tolerances: the losses within
    rtol 1e-4, the updates of every tensor of 256 elements or more and of
    each network pooled statistically close."""
    want = ref["losses"]
    assert np.all(want[3:] > 0)  # GP and perceptual terms really ran
    np.testing.assert_allclose(result["losses"].numpy(), want, rtol=1e-4)
    for key in ("gen", "disc"):
        after = _group(ref, f"after_{key}/")
        ours = result[key]
        assert sorted(ours) == sorted(after)
        for name in ours:
            if ours[name].numel() >= 256:
                assert_updates_close(ours[name], after[name],
                                     f"{key} {name}")
        assert_updates_close(
            torch.cat([ours[n].flatten() for n in sorted(ours)]),
            torch.cat([after[n].flatten() for n in sorted(after)]),
            f"{key} pooled")


# ---------------------------------------------------------------------------
# The trainer and its checkpoints.
# ---------------------------------------------------------------------------

def write_pairs(root: str, n: int, size: int, seed: int = 0) -> str:
    """``n`` random pairs under ``root/data/train``; returns ``root/data``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    data = os.path.join(root, "data")
    for sub in ("source", "tactile"):
        os.makedirs(os.path.join(data, "train", sub), exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
                        ).save(os.path.join(data, "train", "source",
                                            f"s_{i:04d}.png"))
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
                        ).save(os.path.join(data, "train", "tactile",
                                            f"t_{i:04d}.tiff"))
    return data


def cli_rank(rank, world, root, argv, tag):
    """``cli.train`` as one rank; each rank writes ``root/{tag}_{rank}.json``
    (its losses, step offset, whether it is the main process)."""
    from tactile_gan_torch.cli import train as train_cli

    trainer = train_cli.main(list(argv))
    with open(os.path.join(root, f"{tag}_{rank}.json"), "w") as f:
        json.dump({"rank": rank, "gen_loss": trainer.gen_loss,
                   "disc_loss": trainer.disc_loss,
                   "l1_loss": trainer.l1_loss,
                   "step_offset": trainer.step_offset,
                   "step": trainer.state.step,
                   "main": trainer.is_main_process,
                   "mesh": trainer.mesh.shape}, f)


def ckpt_rank(rank, world, root):
    """Under a 1 x world tensor-parallel mesh: one step, a DCP save, a
    restore into a freshly seeded state; writes whether every tensor (and
    the step) came back bit for bit, and the split keys."""
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.parallel.mesh import make_mesh
    from tactile_gan_torch.parallel.tensor_parallel import shard_state_tp
    from tactile_gan_torch.train.state import TrainState, make_optimizer
    from tactile_gan_torch.train.step import build_train_step
    from tactile_gan_torch.utils.dist_ckpt import DistCheckpointer, flat_state
    from tactile_gan_torch.models.factory import networks

    cfg = port_config(lambda_per=0)
    mesh = make_mesh(1, world)

    def state_from(seed):
        gen, disc = networks(cfg)
        init_weights(gen, torch.Generator().manual_seed(seed))
        init_weights(disc, torch.Generator().manual_seed(seed + 1))
        st = TrainState(gen, disc, make_optimizer(gen.parameters(), LR, BETA1),
                        make_optimizer(disc.parameters(), LR, BETA1))
        shard_state_tp(mesh, st, MIN_FEATURES)
        return st

    state = state_from(1)
    g = torch.Generator().manual_seed(2)
    batch = [torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=g,
                           dtype=torch.uint8) for _ in range(2)]
    build_train_step(cfg, schedule(), None, mesh)(
        state, *batch, apply_gp=True, generator=g)
    ck = DistCheckpointer(os.path.join(root, "orbax"), mesh.ckpt_group)
    ck.save(state.step, state)
    ck.wait()
    fresh = state_from(9)
    latest = ck.latest_step()
    ck.restore(latest, fresh)
    ck.close()
    a, b = flat_state(state), flat_state(fresh)
    with open(os.path.join(root, f"ckpt_{rank}.json"), "w") as f:
        json.dump({"latest": latest, "step": fresh.step,
                   "equal": sorted(a) == sorted(b) and all(
                       torch.equal(a[k], b[k]) for k in a),
                   "split_keys": sorted(k for k in a if "@shard" in k)}, f)
