"""Do the ranks of a model group compute the same bits?

    python -m tactile_gan_torch.parallel.rank_probe [--device cpu] [--nf 8]
        [--size 64] [--threads N] [--out PATH]

Under tensor parallelism every rank of a model group computes the
gradients of the parameters that are not split itself, from the same
gathered activations. ``parallel/mesh.py`` ``average_gradients`` averages
them over the group all the same; this probe shows whether the ranks'
own results agree without it. Two gloo ranks (on one card they share
``cuda:0``) run a 1x2 mesh (convs of ``--min_features`` output channels or
more split) for a training step of UNet++ at ``--nf`` and
``--size``^2, batch 4, float32 compute, GP and the v1 perceptual loss,
cuDNN deterministic, once with TF32 off and once with it on. Each rank
records its step-1 losses and its step-1 gradients of the unsplit
parameters before the average; the parent compares the ranks tensor by
tensor. Before that, in this process, one
step run twice from the same state must repeat its own gradients, and
``torch.use_deterministic_algorithms(warn_only=True)`` lists the ops it
flags in one step. ``--threads`` sets each rank's CPU threads (default:
torch's, every core). The JSON goes to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import warnings

BATCH = 4


def _state(torch, cfg, seed, device):
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import networks
    from tactile_gan_torch.train.state import TrainState, make_optimizer

    gen, disc = networks(cfg)
    init_weights(gen, torch.Generator().manual_seed(seed))
    init_weights(disc, torch.Generator().manual_seed(seed + 1))
    gen.to(device)
    disc.to(device)
    return TrainState(gen, disc,
                      make_optimizer(gen.parameters(), cfg.lr, cfg.beta1),
                      make_optimizer(disc.parameters(), cfg.lr, cfg.beta1))


def _inputs(torch, cfg, seed, device):
    """(src, tgt, label noise, GP alpha) of each step, on the host."""
    state = _state(torch, cfg, seed, device)
    with torch.no_grad():
        z = torch.zeros((1, cfg.image_size, cfg.image_size, 3), device=device)
        label = tuple(state.disc(z, z)[0].shape[1:])
    g = torch.Generator().manual_seed(seed + 2)
    shape = (BATCH, cfg.image_size, cfg.image_size, 3)
    return [(torch.randint(0, 256, shape, generator=g, dtype=torch.uint8),
             torch.randint(0, 256, shape, generator=g, dtype=torch.uint8),
             torch.randn((BATCH, *label), generator=g),
             torch.rand((BATCH, 1, 1, 1), generator=g))]


@contextlib.contextmanager
def unsplit_gradients():
    """Within it, every ``TrainStep`` of this process appends to the list
    it yields, at each optimizer's turn (D's, then G's), the gradients of
    the parameters that are not split as this rank computed them, before
    ``average_gradients`` (host copies)."""
    from tactile_gan_torch.train.step import TrainStep

    reduce, raw = TrainStep._reduce, []

    def recording(self, params, grads):
        raw.append([g.detach().cpu().clone() for p, g in zip(params, grads)
                    if getattr(p, "tp_shard", None) is None])
        return reduce(self, params, grads)
    TrainStep._reduce = recording
    try:
        yield raw
    finally:
        TrainStep._reduce = reduce


def _run(torch, state, step, inputs, device):
    """The steps over ``inputs``: (losses, ``unsplit_gradients``)."""
    with unsplit_gradients() as raw:
        losses = torch.stack([
            step(state, src.to(device), tgt.to(device), apply_gp=True,
                 label_noise=noise, gp_alpha=alpha).cpu()
            for src, tgt, noise, alpha in inputs])
    return losses, raw


def _unsplit_names(state):
    return [[f"{key}/{n}" for n, p in m.named_parameters()
             if getattr(p, "tp_shard", None) is None]
            for key, m in (("disc", state.disc), ("gen", state.gen))]


def _rank(rank, world, root):
    import torch
    import torch.distributed as dist

    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.models.vgg import load_vgg_features
    from tactile_gan_torch.parallel.mesh import make_mesh
    from tactile_gan_torch.parallel.tensor_parallel import shard_state_tp
    from tactile_gan_torch.train.step import build_train_step

    spec = torch.load(os.path.join(root, "spec.pt"))
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), world), rank=rank, world_size=world)
    cfg = TrainConfig(**spec["cfg"])
    vgg = load_vgg_features(device=dev)
    out = {}
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            mesh = make_mesh(1, world)
            state = _state(torch, cfg, spec["seed"], dev)
            shard_state_tp(mesh, state, spec["min_features"])
            step = build_train_step(cfg, lambda s: cfg.lr, vgg, mesh)
            losses, raw = _run(torch, state, step, spec["inputs"], dev)
            out[tf32] = {"losses": losses, "raw": raw,
                         "names": _unsplit_names(state)}
    finally:
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        dist.destroy_process_group()


def _one_process(torch, cfg, vgg, seed, inputs, device, flag_ops=False):
    """One step without a mesh: (its gradients, the ops flagged)."""
    from tactile_gan_torch.train.step import build_train_step

    state = _state(torch, cfg, seed, device)
    step = build_train_step(cfg, lambda s: cfg.lr, vgg)
    if not flag_ops:
        return _run(torch, state, step, inputs, device)[1], []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            raw = _run(torch, state, step, inputs, device)[1]
    finally:
        torch.use_deterministic_algorithms(False)
    return raw, sorted({str(w.message)[:200] for w in caught
                        if "deterministic" in str(w.message)})


def probe(device="cuda", nf=64, size=256, min_features=256, threads=0,
          seed=43) -> dict:
    import torch
    import torch.multiprocessing as mp

    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.core.device import resolve_device
    from tactile_gan_torch.models.vgg import load_vgg_features

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    cfg = TrainConfig(device=str(dev), nf=nf, image_size=size,
                      batch_size=BATCH, compute_dtype="float32")
    vgg = load_vgg_features(device=dev)
    inputs = _inputs(torch, cfg, seed, dev)
    report = {"device": str(dev), "nf": nf, "size": size,
              "min_features": min_features, "threads": threads or
              torch.get_num_threads()}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        a, _ = _one_process(torch, cfg, vgg, seed, inputs, dev)
        b, _ = _one_process(torch, cfg, vgg, seed, inputs, dev)
        report[f"one_process_repeats_bits_tf32_{tf32}"] = all(
            torch.equal(x, y) for ga, gb in zip(a, b) for x, y in zip(ga, gb))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report["ops_flagged"] = _one_process(torch, cfg, vgg, seed, inputs, dev,
                                         flag_ops=True)[1]
    with tempfile.TemporaryDirectory() as root:
        torch.save({"seed": seed, "inputs": inputs, "device": str(dev),
                    "threads": threads, "min_features": min_features,
                    "cfg": dataclasses.asdict(cfg)},
                   os.path.join(root, "spec.pt"))
        mp.start_processes(_rank, args=(2, root), nprocs=2,
                           start_method="spawn")
        r0, r1 = (torch.load(os.path.join(root, f"rank{r}.pt"))
                  for r in range(2))
    for tf32 in (False, True):
        a, b = r0[tf32], r1[tf32]
        rep = {"losses_equal": torch.equal(a["losses"], b["losses"])}
        for which, ga, gb, names in zip(("D", "G"), a["raw"], b["raw"],
                                        a["names"]):
            unequal = [(n, (x - y).abs().max().item()) for n, x, y in
                       zip(names, ga, gb) if not torch.equal(x, y)]
            rep[f"{which}_unequal"] = f"{len(unequal)} of {len(names)}"
            rep[f"{which}_max_abs_diff"] = max(
                (d for _, d in unequal), default=0.0)
            rep[f"{which}_first_unequal"] = unequal[:4]
        report[f"ranks_tf32_{tf32}"] = rep
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nf", type=int, default=64)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--min_features", type=int, default=0,
                    help="split threshold (default: 4 nf, the 256 "
                         "channels of the trainer at nf 64)")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("perf_out",
                                                  "rank_probe.json"))
    args = ap.parse_args(argv)
    report = probe(args.device, args.nf, args.size,
                   args.min_features or 4 * args.nf, args.threads)
    for k, v in report.items():
        print(f"{k}: {v}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
