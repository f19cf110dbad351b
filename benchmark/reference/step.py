"""The reference training step: one G+D step of the pix2pix GAN in plain
PyTorch, in the order the port's ``train/step.py`` takes it.

1. source u8 -> [-1, 1], target u8 -> [0, 1] (NCHW float32);
2. the generator forward once; D's step sees it detached;
3. D on the stacked (fake, real) pairs, the 'ls' loss with one-sided label
   smoothing (real target clamp(1 + 0.02 N(0, 1), 0, 1), one draw shared
   with G's target), the gradient penalty on a separate D forward of the
   interpolates (alpha U[0, 1), remapped to U[0.5, 1) for version 2),
   differentiated twice, then D's Adam update;
4. G against the updated D: the 'ls' term, L1, and the perceptual term:
   version 1 compares VGG16 features of the target and the fake (both
   ImageNet-normalized as they are, bilinearly resized to 224x224, L1 per
   block under ``w_per``); version 2 runs D on the stacked (fake, real)
   pairs and compares its four feature maps, detached (logged, no
   gradient); then G's Adam update over G's parameters only.

Adam: betas (beta1, 0.99), eps 1e-8, bias-corrected, written out; the rate
follows the multistep schedule (x0.8 at ten milestones between
``epoch_constant`` and ``total_epochs``). The draws (label noise of the
patch map's NHWC shape, then alpha) come from one generator seeded with the
run's seed, in the port's order, so the reference sees the numbers the
port's step draws. ``gradients`` takes one step's gradients without an
update, G's against a D given from outside (the D the judged side's G
step saw). ``fault`` plants a fault for the control readings:
"half_batch" computes the step on the first half of the batch;
"unchanged" leaves every parameter and Adam's state as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.models import vgg_features

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class StepSpec:
    version: int
    lambda_a: float
    lambda_gp: float
    lambda_per: float
    w_per: Sequence[float]
    lr: float
    beta1: float
    epoch_constant: int
    total_epochs: int
    steps_per_epoch: int
    beta2: float = 0.99
    eps: float = 1e-8
    label_smoothing: bool = True


def learning_rate(spec: StepSpec, step: int) -> float:
    ms = np.int16(np.linspace(spec.epoch_constant, spec.total_epochs,
                              11)[:-1]).astype(np.int64)
    epoch = step // max(1, spec.steps_per_epoch)
    decays = int(np.sum(epoch >= ms))
    return float(np.float32(spec.lr) * np.float32(0.8) ** np.float32(decays))


class Adam:
    """Adam over a list of parameters, written out."""

    def __init__(self, params: List[torch.Tensor], spec: StepSpec):
        self.params = params
        self.spec = spec
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], lr: float) -> None:
        s = self.spec
        self.t += 1
        bc1 = 1.0 - s.beta1 ** self.t
        bc2 = math.sqrt(1.0 - s.beta2 ** self.t)
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.add_((g - m) * (1.0 - s.beta1))
            v.mul_(s.beta2).add_(g * g * (1.0 - s.beta2))
            p.sub_((lr / bc1) * m / (v.sqrt() / bc2 + s.eps))


def _draw(shape, uniform: bool, generator, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.zeros(shape, device="meta")
    fn = torch.rand if uniform else torch.randn
    return fn(shape, generator=generator, device=device)


def ls_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def vgg_perceptual(params: Dict[str, torch.Tensor], input_img, target_img,
                   weights: Sequence[float]) -> torch.Tensor:
    def prep(img):
        img = torch.stack([(img[:, c] - m) / s for c, (m, s) in enumerate(
            zip(IMAGENET_MEAN, IMAGENET_STD))], dim=1)
        return F.interpolate(img, size=(224, 224), mode="bilinear",
                             align_corners=False)

    loss = torch.zeros((), device=input_img.device)
    for w, x, y in zip(weights, vgg_features(params, prep(input_img)),
                       vgg_features(params, prep(target_img))):
        loss = loss + torch.mean(torch.abs(x - y)) * w
    return loss


def pan_loss(real_feats, fake_feats, weights: Sequence[float]
             ) -> torch.Tensor:
    w = np.asarray(weights, np.float32)
    w = (w / w.sum()).tolist()
    total = torch.zeros((), device=real_feats[0].device)
    for i in range(4):
        total = total + torch.mean(torch.abs(real_feats[i] - fake_feats[i])
                                   ) * w[i]
    return total


def gradient_penalty(disc, real_a, real_b, fake, alpha, version: int,
                     lambda_gp: float) -> torch.Tensor:
    if version == 2:
        alpha = (alpha + 1.0) / 2.0
    interp = (alpha * real_b + (1.0 - alpha) * fake).detach()
    interp.requires_grad_(True)
    out = disc(real_a, interp)[0].sum()
    (grads,) = torch.autograd.grad(out, interp, create_graph=True)
    flat = (grads + 1e-16).reshape(grads.shape[0], -1)
    return torch.mean(torch.square(flat.norm(dim=1) - 1.0)) * lambda_gp


class ReferenceTrainer:
    """Both networks, their Adam states and the step count; ``step`` runs
    one training step and returns the five losses."""

    def __init__(self, gen, disc, vgg_params: Optional[Dict], spec: StepSpec,
                 generator: Optional[torch.Generator], fault: str = ""):
        self.gen, self.disc, self.vgg = gen, disc, vgg_params
        self.spec = spec
        self.generator = generator
        self.fault = fault
        self.g_params = list(gen.parameters())
        self.d_params = list(disc.parameters())
        self.opt_g = Adam(self.g_params, spec)
        self.opt_d = Adam(self.d_params, spec)
        self.steps = 0

    def step(self, src_u8: torch.Tensor, tgt_u8: torch.Tensor,
             apply_gp: bool = True) -> torch.Tensor:
        """src_u8, tgt_u8: (B, H, W, 3) uint8 on the reference's device."""
        lr = learning_rate(self.spec, self.steps)

        def update_d(d_grads):
            if self.fault != "unchanged":
                self.opt_d.update(list(d_grads), lr)

        losses, _, g_grads = self._grads(src_u8, tgt_u8, apply_gp, update_d)
        if self.fault != "unchanged":
            self.opt_g.update(list(g_grads), lr)
        self.steps += 1
        return losses

    def gradients(self, src_u8: torch.Tensor, tgt_u8: torch.Tensor,
                  apply_gp: bool, disc_after: Dict[str, torch.Tensor]
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
        """network -> leaf -> its gradient in this step; G's is taken with
        D's parameters set to ``disc_after``. Neither Adam moves."""

        def set_d(_):
            with torch.no_grad():
                for name, p in self.disc.named_parameters():
                    p.copy_(disc_after[name])

        _, d_grads, g_grads = self._grads(src_u8, tgt_u8, apply_gp, set_d)
        return {net: dict(zip((n for n, _ in model.named_parameters()),
                              grads))
                for net, model, grads in (("disc", self.disc, d_grads),
                                          ("gen", self.gen, g_grads))}

    def _grads(self, src_u8, tgt_u8, apply_gp, between):
        """The losses and D's and G's gradients of one step; ``between``
        gets D's gradients and runs before G's part."""
        s = self.spec
        dev = src_u8.device
        real_a = (src_u8.float() / 255.0 * 2.0 - 1.0).permute(0, 3, 1, 2)
        real_b = (tgt_u8.float() / 255.0).permute(0, 3, 1, 2)
        batch = real_a.shape[0]
        gen, disc = self.gen, self.disc

        fake = gen(real_a)
        pred, _ = disc(torch.cat([real_a, real_a]),
                       torch.cat([fake.detach(), real_b]))
        hp, wp = pred.shape[2], pred.shape[3]
        noise = (_draw((batch, hp, wp, 1), False, self.generator, dev
                       ).permute(0, 3, 1, 2) if s.label_smoothing
                 else torch.zeros((batch, 1, hp, wp), device=dev))
        alpha = (_draw((batch, 1, 1, 1), True, self.generator, dev)
                 if apply_gp and s.lambda_gp != 0 else None)
        if self.fault == "half_batch":
            rows = slice(0, batch // 2)
            real_a, real_b, fake = real_a[rows], real_b[rows], fake[rows]
            noise = noise[rows]
            alpha = alpha[rows] if alpha is not None else None
            pred, _ = disc(torch.cat([real_a, real_a]),
                           torch.cat([fake.detach(), real_b]))
            batch = batch // 2
        target = torch.clamp(1.0 + 0.02 * noise, 0.0, 1.0)  # ones unsmoothed
        loss_d = (ls_loss(pred[:batch], torch.zeros_like(pred[:batch]))
                  + ls_loss(pred[batch:], target)) / 2.0
        gp = torch.zeros((), device=dev)
        if alpha is not None:
            gp = gradient_penalty(disc, real_a, real_b, fake.detach(), alpha,
                                  s.version, s.lambda_gp)
        d_grads = torch.autograd.grad(loss_d + gp, self.d_params)
        between(d_grads)

        pan = s.lambda_per != 0 and s.version == 2
        if pan:
            pred_g, feats = disc(torch.cat([real_a, real_a]),
                                 torch.cat([fake, real_b]))
            pred_fake_g = pred_g[:batch]
        else:
            pred_fake_g, _ = disc(real_a, fake)
        loss_gan = ls_loss(pred_fake_g, target)
        loss_l1 = torch.mean(torch.abs(real_b - fake))
        loss_g = loss_gan + loss_l1 * s.lambda_a
        loss_per = torch.zeros((), device=dev)
        if pan:
            loss_per = pan_loss([f[batch:].detach() for f in feats],
                                [f[:batch].detach() for f in feats],
                                s.w_per) * s.lambda_per
            loss_g = loss_g + loss_per
        elif s.lambda_per != 0:
            loss_per = vgg_perceptual(self.vgg, real_b, fake,
                                      s.w_per) * s.lambda_per
            loss_g = loss_g + loss_per
        g_grads = torch.autograd.grad(loss_g, self.g_params)
        return (torch.stack([loss_d, loss_gan, loss_l1, gp,
                             loss_per]).detach(), d_grads, g_grads)
