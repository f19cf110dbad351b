"""The trainer (``tactile_gan_tpu/train/loop.py``): builds both networks on
the device, the Adam pair and the multistep schedule, walks the epochs with
the per-epoch gradient-penalty gate, keeps the per-epoch loss means and
writes the artifacts into ``{work_root}/models/{folder_save}``:
``final_model.pth``, ``{gen,disc,l1,per,gp}loss.npy`` and ``params.txt``.

Left out for now (the trainer refuses them): periodic checkpoints
(``--checkpoint_interval``) and the orbax backend, the device-side
augmentation of ``--no-host_aug``, the version-2 perceptual loss and the
network variants ``--space_to_depth`` and ``--disc_same_pad``,
``--legacy_label_cache``. ``--continue_training`` reads a checkpoint the
port wrote.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.core.device import resolve_device
from tactile_gan_torch.data.dataset import PairedDataset
from tactile_gan_torch.models.blocks import init_weights
from tactile_gan_torch.models.factory import create_discriminator, create_generator
from tactile_gan_torch.models.vgg import (
    fallback_banner, load_vgg_features, resolve_weights_path,
)
from tactile_gan_torch.train.schedule import multistep_lr
from tactile_gan_torch.train.state import TrainState, make_optimizer
from tactile_gan_torch.train.step import METRICS, build_train_step
from tactile_gan_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tactile_gan_torch.utils.io import mkdir


def _refuse_unported(cfg: TrainConfig) -> None:
    unported = {
        "--space_to_depth": cfg.space_to_depth,
        "--disc_same_pad": cfg.disc_same_pad,
        "--legacy_label_cache": cfg.legacy_label_cache,
        "--checkpoint_interval": cfg.checkpoint_interval != -1,
        "--ckpt_backend orbax": cfg.ckpt_backend != "native",
        "--no-host_aug (device-side augmentation)":
            not cfg.host_aug and not cfg.no_aug,
    }
    named = [k for k, v in unported.items() if v]
    if named:
        raise NotImplementedError(
            f"not ported yet: {', '.join(named)} (ROADMAP.md, queue 1)")


class Trainer:

    def __init__(self, cfg: TrainConfig, dataset: PairedDataset):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(cfg.device)
        cd = cfg.torch_compute_dtype
        self.gen = create_generator(cfg.gen, input_dim=cfg.input_dim,
                                    output_dim=cfg.output_dim, nf=cfg.nf,
                                    activation=cfg.activation,
                                    compute_dtype=cd)
        self.disc = create_discriminator("patch", input_dim=cfg.input_dim,
                                         output_dim=cfg.output_dim, nf=cfg.nf,
                                         activation=cfg.activation,
                                         compute_dtype=cd)
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

        restored = None
        if cfg.continue_training:
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
            for opt, key in ((opt_g, "optimizerG_state_dict"),
                             (opt_d, "optimizerD_state_dict")):
                if key in restored:
                    opt.load_state_dict(restored[key])
            self.step_offset = int(restored.get("step", 0))
        self.state = TrainState(self.gen, self.disc, opt_g, opt_d,
                                step=self.step_offset)
        self.schedule = multistep_lr(cfg.lr, cfg.epoch_constant,
                                     cfg.total_epochs, self.steps_per_epoch,
                                     step_offset=self.step_offset)

        vgg = None
        self.vgg_random_fallback = False
        if cfg.lambda_per != 0 and cfg.version == 1:
            if not resolve_weights_path(cfg.vgg_weights):
                self.vgg_random_fallback = True
                print(fallback_banner())
            vgg = load_vgg_features(cfg.vgg_weights, device=self.device)
        self.step_fn = build_train_step(cfg, self.schedule, vgg)
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.seed)

        self.gen_loss, self.disc_loss = [], []
        self.l1_loss, self.per_loss, self.gp_loss = [], [], []
        self.epoch_seconds = []

    def train(self, progress: bool = True) -> None:
        cfg = self.cfg
        host_aug = cfg.host_aug and not cfg.no_aug and self.dataset.aug
        for i in range(cfg.total_epochs):
            epoch = i + cfg.initial_epoch
            apply_gp = (cfg.reg_every != 0 and epoch % cfg.reg_every == 0
                        and cfg.lambda_gp != 0)
            t0 = time.time()
            metrics = []
            for src_u8, tgt_u8, _ in self.dataset.batches(
                    cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
                    drop_last=not self.pad_mode, pad_to_batch=self.pad_mode,
                    threads=cfg.threads, host_augment=host_aug,
                    augment_seed=cfg.seed + 7919 * epoch):
                src = torch.from_numpy(src_u8).to(self.device)
                tgt = torch.from_numpy(tgt_u8).to(self.device)
                metrics.append(self.step_fn(self.state, src, tgt,
                                            apply_gp=apply_gp,
                                            generator=self.rng))
            # One device-to-host transfer per epoch.
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

    def save_model(self, modelpath: str) -> None:
        s = self.state
        save_checkpoint(modelpath, gen=s.gen.state_dict(),
                        disc=s.disc.state_dict(),
                        opt_g=s.opt_g.state_dict(),
                        opt_d=s.opt_d.state_dict(), step=s.step)

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
        """Train, then write the model, the loss arrays and params.txt.
        Returns the model directory."""
        save_path = self.cfg.models_dir()
        mkdir(save_path)
        self.train(progress=progress)
        self.save_model(os.path.join(save_path, "final_model.pth"))
        self.save_arrays(save_path)
        self.save_hyper_params(save_path)
        return save_path
