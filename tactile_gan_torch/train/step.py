"""One G+D training step, in the order of ``tactile_gan_tpu/train/step.py``:

1. preprocess the uint8 batch (``data/augment.py``): with ``--no-host_aug``
   (and augmentation on) the joint flip and affine run here on the device;
   then source to [-1, 1], target to [0, 1];
2. run the generator forward once; the D step takes its output detached,
   the G step differentiates through the same graph;
3. D on the stacked (fake, real) pair, the gradient penalty when this epoch
   applies it (a separate B-row D forward, differentiated twice), then the
   D Adam update;
4. score G against the *updated* D: the GAN loss, L1 and the perceptual
   loss, then the G Adam update (gradients taken over G's parameters only,
   so no D weight gradient is computed or left behind). Version 1 compares
   VGG features; version 2 (``pan_loss``) runs that D forward on the
   stacked (fake, real) pair and compares its four feature maps, both sets
   detached, so the term is logged and gives G no gradient.

One label-smoothing draw is shared by the D-real and G targets; with
``--legacy_label_cache`` one draw a prediction shape, kept on the step, is
reused by every step of the run (the reference's cached tensor). The draws
(augmentation, label noise, the GP's alpha) come from ``generator`` unless
the caller injects them (``aug_draws``, ``label_noise``, ``gp_alpha``), as
the tests do with the JAX step's own draws. Losses come back as one
float32 tensor on the device: [loss_d, loss_g (the GAN term), loss_l1,
loss_gp, loss_per].

Data parallelism (``mesh``, ``parallel/mesh.py``): the rank's batch is its
rows of the global batch. Every draw is made for the global batch from the
rank's generator (seeded alike on every rank) and the step keeps its own
rows, so a rank sees the draws a one-process step gives those rows;
injected draws are global too. Each optimizer's gradients are averaged
over the data group (one flattened all-reduce; with a model axis the
parameters that are not split over every rank, ``average_gradients``),
and so is the loss vector, so every rank takes the update and
reports the losses of the global batch, as the JAX package's psum does;
this also sums kernel D's per-rank weight-gradient partials. With no mesh
the step is the one-process step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.data.augment import (
    AugmentDraws, draw_augment, preprocess_batch,
)
from tactile_gan_torch.losses.gan_loss import gan_loss
from tactile_gan_torch.losses.gradient_penalty import gradient_penalty
from tactile_gan_torch.losses.perceptual import (
    l1_loss, pan_loss, vgg_perceptual_loss,
)
from tactile_gan_torch.parallel.mesh import (
    Mesh, all_reduce_mean, average_gradients,
)
from tactile_gan_torch.train.state import TrainState, set_lr

METRICS = ("loss_d", "loss_g", "loss_l1", "loss_gp", "loss_per")


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


class TrainStep:
    """``step(state, src_u8, tgt_u8, *, apply_gp, generator=None,
    aug_draws=None, label_noise=None, gp_alpha=None)`` -> the five losses
    (device tensor):
    ``set_lr`` (the schedule's rate at ``state.step``, set outside any
    captured region), then ``compute`` (the step's device work, which moves
    no Python counter), then ``state.step += 1``. ``train/graph.py``
    captures ``compute`` and runs the other two around each replay."""

    def __init__(self, cfg: TrainConfig, schedule: Callable[[int], float],
                 vgg_params: Optional[Dict[str, torch.Tensor]] = None,
                 mesh: Optional[Mesh] = None):
        if cfg.lambda_per != 0 and cfg.version == 1 and vgg_params is None:
            raise ValueError("the v1 perceptual loss needs the VGG tower")
        self.cfg = cfg
        self.schedule = schedule
        self.vgg_params = vgg_params
        self.mesh = mesh
        # With --host_aug the flip and affine already ran on the host.
        self.augment = not cfg.no_aug and not cfg.host_aug
        # --legacy_label_cache: prediction shape -> the run's one draw.
        self.label_cache: Dict[Tuple[int, ...], torch.Tensor] = {}

    def set_lr(self, state: TrainState) -> None:
        lr = self.schedule(state.step)
        set_lr(state.opt_d, lr)
        set_lr(state.opt_g, lr)

    def _label_noise(self, shape, device, generator, injected):
        """The step's standard-normal label draw: the injected one, or one
        from ``generator``; under --legacy_label_cache the first of these
        for ``shape`` is kept and every later step reuses it."""
        key = tuple(shape)
        if self.cfg.legacy_label_cache and key in self.label_cache:
            return self.label_cache[key]
        noise = (injected.to(device) if injected is not None else
                 torch.randn(key, generator=generator, device=device))
        if self.cfg.legacy_label_cache:
            self.label_cache[key] = noise
        return noise

    def _rows(self, batch: int) -> Tuple[int, slice]:
        """(the global batch, this rank's rows of it) for a local batch."""
        if self.mesh is None:
            return batch, slice(None)
        d = self.mesh.data_index
        return batch * self.mesh.n_data, slice(d * batch, (d + 1) * batch)

    def _reduce(self, params, grads):
        """The gradients of ``params`` averaged over the ranks that update
        them (as given without a mesh)."""
        if self.mesh is None:
            return list(grads)
        return average_gradients(params, grads, self.mesh)

    def compute(self, state: TrainState, src_u8: torch.Tensor,
                tgt_u8: torch.Tensor, *, apply_gp: bool,
                generator: Optional[torch.Generator] = None,
                aug_draws: Optional[AugmentDraws] = None,
                label_noise: Optional[torch.Tensor] = None,
                gp_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        mode, smoothing = cfg.loss, cfg.label_smoothing
        gen, disc = state.gen, state.disc
        batch = src_u8.shape[0]
        total, rows = self._rows(batch)
        if self.augment:
            if aug_draws is None:
                aug_draws = draw_augment(total, src_u8.shape[1],
                                         src_u8.shape[2], generator,
                                         src_u8.device)
            aug_draws = AugmentDraws(*(t[rows] for t in aug_draws))
        real_a, real_b = preprocess_batch(src_u8, tgt_u8,
                                          augment=self.augment,
                                          draws=aug_draws)

        fake = gen(real_a)

        # ---------------- D update ----------------
        fake_det = fake.detach()
        pred, _ = disc(torch.cat([real_a, real_a]),
                       torch.cat([fake_det, real_b]))
        pred_fake, pred_real = pred[:batch], pred[batch:]
        noise = None
        if smoothing:
            noise = self._label_noise((total, *pred_real.shape[1:]),
                                      pred.device, generator,
                                      label_noise)[rows]
        loss_d = (gan_loss(pred_fake, False, mode=mode)
                  + gan_loss(pred_real, True, mode=mode,
                             label_smoothing=smoothing, noise=noise)) / 2.0
        gp = torch.zeros((), device=pred.device)
        if apply_gp and cfg.lambda_gp != 0:
            alpha = (gp_alpha if gp_alpha is not None else torch.rand(
                (total, 1, 1, 1), generator=generator,
                device=pred.device))[rows]
            gp = gradient_penalty(lambda img, mask: disc(img, mask)[0],
                                  real_a, real_b, fake_det,
                                  alpha.to(pred.device), version=cfg.version,
                                  lambda_gp=cfg.lambda_gp)
        d_params = list(disc.parameters())
        _apply(state.opt_d, d_params, self._reduce(
            d_params, torch.autograd.grad(loss_d + gp, d_params)))

        # -------- G update, against the updated D --------
        pan = cfg.lambda_per != 0 and cfg.version == 2
        if pan:
            # One D forward of 2B rows gives the fake's logits and both
            # pairs' features (every D op is per sample).
            pred_g, feats = disc(torch.cat([real_a, real_a]),
                                 torch.cat([fake, real_b]))
            pred_fake_g = pred_g[:batch]
            feats_fake = [f[:batch].detach() for f in feats]
            feats_real = [f[batch:].detach() for f in feats]
        else:
            pred_fake_g, _ = disc(real_a, fake)
        loss_gan = gan_loss(pred_fake_g, True, mode=mode,
                            for_discriminator=False,
                            label_smoothing=smoothing, noise=noise)
        loss_l1 = l1_loss(real_b, fake)
        loss_g = loss_gan + loss_l1 * cfg.lambda_a
        loss_per = torch.zeros((), device=pred.device)
        if pan:
            loss_per = pan_loss(feats_real, feats_fake,
                                weights=cfg.w_per) * cfg.lambda_per
            loss_g = loss_g + loss_per
        elif cfg.lambda_per != 0:
            loss_per = vgg_perceptual_loss(self.vgg_params, real_b, fake,
                                           weights=cfg.w_per) * cfg.lambda_per
            loss_g = loss_g + loss_per
        g_params = list(gen.parameters())
        _apply(state.opt_g, g_params, self._reduce(
            g_params, torch.autograd.grad(loss_g, g_params)))
        losses = torch.stack([loss_d, loss_gan, loss_l1, gp,
                              loss_per]).detach().float()
        return losses if self.mesh is None else all_reduce_mean(
            [losses], self.mesh.data_group, self.mesh.n_data)[0]

    def __call__(self, state: TrainState, src_u8: torch.Tensor,
                 tgt_u8: torch.Tensor, **kw) -> torch.Tensor:
        self.set_lr(state)
        losses = self.compute(state, src_u8, tgt_u8, **kw)
        state.step += 1
        return losses


def build_train_step(cfg: TrainConfig, schedule: Callable[[int], float],
                     vgg_params: Optional[Dict[str, torch.Tensor]] = None,
                     mesh: Optional[Mesh] = None) -> TrainStep:
    """The eager step (``TrainStep``) of ``cfg`` under ``schedule``."""
    return TrainStep(cfg, schedule, vgg_params, mesh)
