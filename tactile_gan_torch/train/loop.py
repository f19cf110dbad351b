"""The trainer (``tactile_gan_tpu/train/loop.py``): builds both networks on
the device, the Adam pair and the multistep schedule, walks the epochs with
the per-epoch gradient-penalty gate, keeps the per-epoch loss means and
writes the artifacts into ``{work_root}/models/{folder_save}``:
``final_model.pth``, ``{gen,disc,l1,per,gp}loss.npy`` and ``params.txt``;
with ``--checkpoint_interval N``, ``checkpoints/{folder_save}/model_{epoch}
.pth`` every N epochs (the port's torch format, written on a background
thread).

On the card the step runs as one CUDA graph per gradient-penalty variant
(``train/graph.py``) and the batches come through ``data/prefetch.py``, so
batch k+1 is on the device when step k ends; on the CPU both stay eager.
``--continue_training`` reads ``final_model.pth`` in either format (the
port's, or the JAX package's msgpack, whose ``step`` restarts the schedule
as the JAX trainer does). ``--debug_nans`` raises ``FloatingPointError``
after the first step whose losses are not finite (the JAX package also
turns on ``jax_debug_nans``, which raises inside the step at the first
non-finite operation; the port has no such per-operation check), and
``--profile_dir`` traces the first epoch, graph replays included, as in the
JAX package. With ``--no-host_aug`` the dataset yields batches as decoded
and the step augments them on the device (``data/augment.py``).

Parallel runs (``parallel/mesh.py``): under torchrun, or in a process group
its caller made, the trainer forms a ``--mesh_data x --mesh_model`` mesh of
the ranks (``--mesh_data 0``: world // mesh_model). Each rank decodes its
rows of every global batch, the step averages gradients and losses over
its data group, and with a model axis the wide convs are split over it
(``parallel/tensor_parallel.py``). Rank 0 alone prints and writes the
artifacts and the native checkpoints; under a model axis the split tensors
are gathered first, so ``final_model.pth`` is the file one process writes.
A rank's device is ``cuda:{LOCAL_RANK}`` (``--device cuda``) or the one
given. Ranks that share a card run gloo, whose collectives a CUDA graph
cannot capture: there ``graphed=True`` raises.

``--ckpt_backend orbax`` writes the periodic checkpoints with
``utils/dist_ckpt.py`` into ``checkpoints/{folder_save}/orbax/{step}``
(every rank its own share, async); ``--continue_training`` then resumes
from the latest complete step there, else from ``final_model.pth``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.core.device import resolve_device
from tactile_gan_torch.data.dataset import PairedDataset
from tactile_gan_torch.data.prefetch import Prefetcher
from tactile_gan_torch.models.blocks import init_weights
from tactile_gan_torch.models.factory import networks
from tactile_gan_torch.models.vgg import (
    fallback_banner, load_vgg_features, resolve_weights_path,
)
from tactile_gan_torch.parallel.mesh import (
    Mesh, choose_backend, local_batch_rows, local_rank, make_mesh,
    maybe_init_distributed, mesh_shape, rank_device, ranks_on_host,
)
from tactile_gan_torch.parallel.tensor_parallel import (
    full_state_dicts, shard_state_tp,
)
from tactile_gan_torch.train.graph import GraphedStep
from tactile_gan_torch.train.schedule import multistep_lr
from tactile_gan_torch.train.state import (
    TrainState, load_optimizer_state, make_optimizer,
)
from tactile_gan_torch.train.step import METRICS, build_train_step
from tactile_gan_torch.utils.checkpoint import (
    AsyncCheckpointer, load_checkpoint, save_checkpoint,
)
from tactile_gan_torch.utils.convert import load_adam_state
from tactile_gan_torch.utils.dist_ckpt import DistCheckpointer
from tactile_gan_torch.utils.io import mkdir
from tactile_gan_torch.utils.profiling import nan_guard, trace


# Output channels from which a conv is split over the model axis.
TP_MIN_FEATURES = 256


def trainer_mesh(cfg: TrainConfig) -> "Mesh | None":
    """The mesh of ``cfg``'s run: None for one process with no launch
    environment; else ``--mesh_data x --mesh_model`` over the process
    group (joined from torchrun's environment, or made by the caller)."""
    maybe_init_distributed(cfg.device)
    if not dist.is_initialized():
        mesh_shape(cfg.mesh_data, max(1, cfg.mesh_model), 1)  # validates
        return None
    return make_mesh(cfg.mesh_data, max(1, cfg.mesh_model))


def _restore_optimizer(opt: torch.optim.Adam, model: torch.nn.Module,
                       saved) -> None:
    """A torch optimizer state_dict (the port's checkpoints) or the JAX
    package's Adam state as ``load_checkpoint`` converts it (count and
    moments in the port's parameter names)."""
    if "param_groups" in saved:
        load_optimizer_state(opt, saved)
    else:
        load_adam_state(opt, model, saved["mu"], saved["nu"], saved["count"],
                        dict)


class Trainer:
    """``graphed`` (a test hook): on the card, run the step as CUDA graphs
    (the default) or eager."""

    def __init__(self, cfg: TrainConfig, dataset: PairedDataset,
                 graphed: bool = True):
        self.cfg = cfg
        self.dataset = dataset
        self.mesh = trainer_mesh(cfg)
        self.is_main_process = self.mesh is None or self.mesh.rank == 0
        device = cfg.device
        if self.mesh is not None:
            choose_backend(device, self.mesh.backend, ranks_on_host())
            device = rank_device(device, local_rank())
        self.device = resolve_device(device)
        if (graphed and self.device.type == "cuda" and self.mesh is not None
                and self.mesh.backend == "gloo"):
            raise ValueError("gloo collectives cannot be captured into a "
                             "CUDA graph: pass graphed=False to run the "
                             "step eager on ranks that share a card")
        self._local_rows = (local_batch_rows(cfg.batch_size, self.mesh)
                            if self.mesh is not None else slice(None))
        self.gen, self.disc = networks(cfg)
        init_weights(self.gen, torch.Generator().manual_seed(cfg.seed))
        init_weights(self.disc, torch.Generator().manual_seed(cfg.seed + 1))

        n = len(dataset)
        if n == 0:
            raise ValueError(f"no images found under {dataset.img_dir}")
        # Pad mode only for datasets smaller than one batch (or
        # drop_last=False): the final short batch repeats its last pair.
        self.pad_mode = n < cfg.batch_size or not cfg.drop_last
        self.steps_per_epoch = (-(-n // cfg.batch_size) if self.pad_mode
                                else n // cfg.batch_size)

        # --ckpt_backend orbax: the latest complete step checkpoint takes
        # precedence over final_model.pth (which exists only after a run
        # that ended); it is read once the sharded state exists.
        ckpt_group = self.mesh.ckpt_group if self.mesh is not None else None
        resume, resume_step = None, None
        if cfg.continue_training and cfg.ckpt_backend == "orbax":
            resume = DistCheckpointer(os.path.join(
                cfg.work_root, "checkpoints", cfg.folder_load, "orbax"),
                ckpt_group)
            resume_step = resume.latest_step()
        restored = None
        if cfg.continue_training and resume_step is None:
            restored = load_checkpoint(os.path.join(
                cfg.work_root, "models", cfg.folder_load, "final_model.pth"))
            self.gen.load_state_dict(restored["gen"])
            if "disc" in restored:
                self.disc.load_state_dict(restored["disc"])
        self.gen.to(self.device)
        self.disc.to(self.device)
        opt_g = make_optimizer(self.gen.parameters(), cfg.lr, cfg.beta1)
        opt_d = make_optimizer(self.disc.parameters(), cfg.lr, cfg.beta1)
        self.step_offset = 0
        if restored is not None:
            for opt, model, key in ((opt_g, self.gen, "optimizerG_state_dict"),
                                    (opt_d, self.disc,
                                     "optimizerD_state_dict")):
                if key in restored:
                    _restore_optimizer(opt, model, restored[key])
            self.step_offset = int(restored.get("step", 0))
        self.state = TrainState(self.gen, self.disc, opt_g, opt_d,
                                step=self.step_offset)
        if self.mesh is not None:
            shard_state_tp(self.mesh, self.state, TP_MIN_FEATURES)
        self.checkpointer = AsyncCheckpointer()
        self.dist_ckpt = None
        if cfg.ckpt_backend == "orbax" and cfg.checkpoint_interval != -1:
            self.dist_ckpt = DistCheckpointer(
                os.path.join(self.checkpoints_dir(), "orbax"), ckpt_group)
        if resume_step is not None:
            resume.restore(resume_step, self.state)
            self.step_offset = resume_step
        if resume is not None:
            resume.close()
        self.schedule = multistep_lr(cfg.lr, cfg.epoch_constant,
                                     cfg.total_epochs, self.steps_per_epoch,
                                     step_offset=self.step_offset)

        vgg = None
        self.vgg_random_fallback = False
        if cfg.lambda_per != 0 and cfg.version == 1:
            if not resolve_weights_path(cfg.vgg_weights):
                self.vgg_random_fallback = True
                if self.is_main_process:
                    print(fallback_banner())
            vgg = load_vgg_features(cfg.vgg_weights, device=self.device)
        self.step_fn = build_train_step(cfg, self.schedule, vgg, self.mesh)
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.graphed = (GraphedStep(self.step_fn, self.state, self.rng)
                        if graphed and self.device.type == "cuda" else None)
        self.prefetch = Prefetcher(self.device)

        self.gen_loss, self.disc_loss = [], []
        self.l1_loss, self.per_loss, self.gp_loss = [], [], []
        self.epoch_seconds = []

    def train(self, progress: bool = True) -> None:
        cfg = self.cfg
        progress = progress and self.is_main_process
        host_aug = cfg.host_aug and not cfg.no_aug and self.dataset.aug
        for i in range(cfg.total_epochs):
            epoch = i + cfg.initial_epoch
            apply_gp = (cfg.reg_every != 0 and epoch % cfg.reg_every == 0
                        and cfg.lambda_gp != 0)
            t0 = time.time()
            profiler = (trace(cfg.profile_dir, self.device.type == "cuda")
                        if cfg.profile_dir and i == 0
                        else contextlib.nullcontext())
            metrics = []
            with profiler:
                for src, tgt, _ in self.prefetch(self.dataset.batches(
                        cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
                        drop_last=not self.pad_mode,
                        pad_to_batch=self.pad_mode, threads=cfg.threads,
                        local_rows=self._local_rows, host_augment=host_aug,
                        augment_seed=cfg.seed + 7919 * epoch)):
                    metrics.append(self._step(src, tgt, apply_gp))
                    if cfg.debug_nans:  # one transfer a step
                        nan_guard(dict(zip(METRICS, metrics[-1].tolist())),
                                  step_info=f"(epoch {epoch}, step "
                                            f"{self.state.step})")
            # One device-to-host transfer per epoch (without --debug_nans).
            means = dict(zip(METRICS, torch.stack(metrics).mean(dim=0)
                             .cpu().numpy().tolist()))
            self.epoch_seconds.append(time.time() - t0)
            self.disc_loss.append(means["loss_d"])
            self.gen_loss.append(means["loss_g"])
            self.l1_loss.append(means["loss_l1"])
            self.gp_loss.append(means["loss_gp"])
            self.per_loss.append(means["loss_per"])
            if progress:
                dt = self.epoch_seconds[-1]
                # The reference prints the next epoch's learning rate.
                lr_now = self.schedule(self.step_offset
                                       + (i + 1) * self.steps_per_epoch)
                print(f"==training epoch {epoch}")
                print(f"\tloss functions => D:{means['loss_d']:.5f}, "
                      f"G:{means['loss_g']:.5f}, L1:{means['loss_l1']:.5f}, "
                      f"gp:{means['loss_gp']:.5f}, per:{means['loss_per']:.5f}")
                print(f"\tlearning rate: {lr_now:.5f}")
                print(f"\ttook {dt:.2f} seconds")
                print(f"\tapproximately {dt * (cfg.total_epochs - epoch):.2f} "
                      f"seconds left", flush=True)
            if (cfg.checkpoint_interval != -1
                    and epoch % cfg.checkpoint_interval == 0):
                if self.dist_ckpt is not None:
                    self.dist_ckpt.save(self.state.step, self.state)
                else:
                    state = self._state_dicts()  # collective under TP
                    if self.is_main_process:
                        self.checkpointer.save(os.path.join(
                            self.checkpoints_dir(), f"model_{epoch}.pth"),
                            **state)
        self.checkpointer.wait()
        if self.dist_ckpt is not None:
            self.dist_ckpt.wait()

    def _step(self, src: torch.Tensor, tgt: torch.Tensor,
              apply_gp: bool) -> torch.Tensor:
        if self.graphed is not None:
            return self.graphed(src, tgt, apply_gp=apply_gp)
        return self.step_fn(self.state, src, tgt, apply_gp=apply_gp,
                            generator=self.rng)

    def checkpoints_dir(self) -> str:
        return os.path.join(self.cfg.work_root, "checkpoints",
                            self.cfg.folder_save)

    def _state_dicts(self) -> dict:
        """The state as one process holds it; split tensors gathered to
        full shape (collective: every rank calls it under a model axis)."""
        s = self.state
        return dict(full_state_dicts(s), step=s.step)

    def save_model(self, modelpath: str) -> None:
        """Write ``modelpath`` on rank 0 (collective: every rank calls)."""
        state = self._state_dicts()
        if self.is_main_process:
            save_checkpoint(modelpath, **state)

    def save_arrays(self, path: str) -> None:
        for name, values in (("genloss", self.gen_loss),
                             ("discloss", self.disc_loss),
                             ("l1loss", self.l1_loss),
                             ("perloss", self.per_loss),
                             ("gploss", self.gp_loss)):
            np.save(os.path.join(path, name), np.asarray(values))

    def save_hyper_params(self, folderpath: str) -> None:
        extra = {}
        if self.cfg.lambda_per != 0 and self.cfg.version == 1:
            extra["vgg_random_fallback"] = self.vgg_random_fallback
        self.cfg.save_params(folderpath, extra=extra)

    def run_and_save(self, progress: bool = True) -> str:
        """Train, then write the model, the loss arrays and params.txt (on
        rank 0). Returns the model directory."""
        save_path = self.cfg.models_dir()
        if self.is_main_process:
            mkdir(self.checkpoints_dir())
            mkdir(save_path)
        self.train(progress=progress)
        self.save_model(os.path.join(save_path, "final_model.pth"))
        if self.is_main_process:
            self.save_arrays(save_path)
            self.save_hyper_params(save_path)
        return save_path
