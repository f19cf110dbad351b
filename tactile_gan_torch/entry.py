"""Entry points for a compile check and a multi-rank dry run (the port's
counterparts of ``__graft_entry__.py``).

- ``entry(device)``: the flagship generator's forward (UNet++ nf 64, the
  reference default, bf16 compute) with zero weights and an example
  batch of 4 at 256x256, NHWC float32.
- ``dryrun_multichip(n, device)``: the real ``Trainer`` (loader, host
  augmentation, GAN + L1 + perceptual losses, gradient penalty, both Adam
  updates, the artifacts) over ``n`` ranks at tiny shapes. Phase 1: a data
  x model mesh (n/2 x 2 for even n >= 4, else n x 1) at nf 16, where the
  widest UNet++ convs (16 nf = 256 channels) are split over the model axis,
  with the ``--version 2`` losses; phase 2: pure data parallelism (n x 1),
  version 1 without the perceptual term, bf16 compute with bf16-resident
  UNet++ rows and discriminator (``--bf16_resident --disc_bf16``, the JAX
  dry run's production dtype story), which each rank checks reached both
  models. The ranks meet
  over a file store and run eager steps. Their transport is NCCL, one card
  a rank, when the host has a card for each; with fewer cards they share
  ``cuda:0`` over gloo, and on ``device="cpu"`` they run gloo on the CPU.
  Rank 0 prints which.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def entry(device="cuda"):
    """``(fn, (x,))``: ``fn(x)`` is the forward of UNet++ nf 64 with every
    parameter zero; ``x`` zeros of shape (4, 256, 256, 3)."""
    from tactile_gan_torch.core.device import resolve_device
    from tactile_gan_torch.models.factory import create_generator

    dev = resolve_device(device)
    model = create_generator("UNet++", output_dim=3, nf=64, activation=True,
                             compute_dtype=torch.bfloat16).to(dev)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    x = torch.zeros((4, 256, 256, 3), dtype=torch.float32, device=dev)

    def fn(inp):
        with torch.no_grad():
            return model(inp)

    return fn, (x,)


def _write_synth_pairs(root: str, n: int, size: int) -> str:
    """Random paired images (source .png, tactile .tiff) under
    ``root/train``; returns the source directory."""
    from PIL import Image

    sdir = os.path.join(root, "train", "source")
    tdir = os.path.join(root, "train", "tactile")
    os.makedirs(sdir, exist_ok=True)
    os.makedirs(tdir, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        src = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        tgt = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        Image.fromarray(src).save(os.path.join(sdir, f"s_{i:04d}.png"))
        Image.fromarray(tgt).save(os.path.join(tdir, f"t_{i:04d}.tiff"))
    return sdir


def _phases(n: int, root: str, device: str):
    """The two phases: (what rank 0 prints after "ok"-ing it, TrainConfig)."""
    import dataclasses

    from tactile_gan_torch.core.config import TrainConfig

    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = max(1, n // n_model)
    cfg = TrainConfig(
        data=os.path.join(root, "data"), gen="UNet++", nf=16,
        batch_size=max(n_data, 2), image_size=32, loss="ls", lambda_per=1.0,
        version=2, lambda_gp=0.01, reg_every=1, total_epochs=1, threads=2,
        compute_dtype="float32", mesh_data=n_data, mesh_model=n_model,
        folder_save="dryrun", checkpoint_interval=-1, device=device)
    cfg2 = dataclasses.replace(
        cfg, mesh_data=n, mesh_model=1, batch_size=max(n, 2),
        folder_save="dryrun_kernels", lambda_per=0.0, version=1,
        compute_dtype="bfloat16", host_aug=True, bf16_resident=True,
        disc_bf16=True)
    return [(f"ok — mesh {n_data}x{n_model} (data x model)", cfg),
            (f"kernels-under-mesh ok — mesh {n}x1", cfg2)]


def transport(n_devices: int, device: str) -> tuple:
    """(backend, the device string each rank passes to the trainer) of
    ``n_devices`` ranks: nccl on ``cuda`` (the trainer takes
    ``cuda:{rank}``) when there is a card a rank, else gloo on ``cuda:0``
    shared, or gloo on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo", "cpu"
    if torch.cuda.device_count() >= n_devices:
        return "nccl", "cuda"
    return "gloo", "cuda:0"


def _rank(rank: int, n: int, root: str, backend: str, device: str) -> None:
    """One rank of ``dryrun_multichip``: both phases; rank 0 prints."""
    import torch.distributed as dist

    from tactile_gan_torch.data.dataset import PairedDataset
    from tactile_gan_torch.train.loop import Trainer

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(root, "store"), n), rank=rank, world_size=n)
    if rank == 0:
        print(f"dryrun_multichip({n}): {backend} over {n} ranks, " + (
            "a card each" if backend == "nccl" else f"all on {device}"),
            flush=True)
    try:
        for line, cfg in _phases(n, root, device):
            dataset = PairedDataset(
                os.path.join(cfg.data, "train", "source"),
                size=cfg.image_size, mode="train", aug=True)
            trainer = Trainer(cfg, dataset, graphed=False)
            want = {"data": cfg.mesh_data, "model": cfg.mesh_model}
            if trainer.mesh is None or trainer.mesh.shape != want:
                raise AssertionError(f"mesh {trainer.mesh}, expected {want}")
            if cfg.bf16_resident and not trainer.gen.bf16_resident:
                raise AssertionError("bf16_resident did not reach the "
                                     "generator")
            if cfg.disc_bf16 and not trainer.disc.resident:
                raise AssertionError("disc_bf16 did not reach the "
                                     "discriminator")
            trainer.run_and_save(progress=False)
            losses = dict(G=trainer.gen_loss[-1], D=trainer.disc_loss[-1],
                          gp=trainer.gp_loss[-1])
            if cfg.lambda_per:
                losses["per"] = trainer.per_loss[-1]
            if not all(np.isfinite(v) for v in losses.values()):
                raise AssertionError(f"losses not finite: {losses}")
            if rank == 0:
                print(f"dryrun_multichip({n}): {line} — " + " ".join(
                    f"{k}={v:.4f}" for k, v in losses.items()), flush=True)
            del trainer
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Train both phases over ``n_devices`` spawned ranks (``transport``).
    Raises if a rank fails."""
    import torch.multiprocessing as mp

    from tactile_gan_torch.core.device import resolve_device

    backend, rank_device = transport(n_devices,
                                     str(resolve_device(device)))
    with tempfile.TemporaryDirectory() as root:
        n_data = max(1, n_devices // (2 if n_devices % 2 == 0
                                      and n_devices >= 4 else 1))
        _write_synth_pairs(os.path.join(root, "data"),
                           n=2 * max(n_data, 2), size=32)
        mp.start_processes(_rank, args=(n_devices, root, backend,
                                        rank_device),
                           nprocs=n_devices, start_method="spawn")
