"""One G+D training step, in the order of ``tactile_gan_tpu/train/step.py``:

1. normalize the uint8 batch: source to [-1, 1], target to [0, 1] (host
   augmentation, when on, already ran in the data pipeline);
2. run the generator forward once; the D step takes its output detached,
   the G step differentiates through the same graph;
3. D on the stacked (fake, real) pair, the gradient penalty when this epoch
   applies it (a separate B-row D forward, differentiated twice), then the
   D Adam update;
4. score G against the *updated* D: the GAN loss, L1 and the v1 perceptual
   loss, then the G Adam update (gradients taken over G's parameters only,
   so no D weight gradient is computed or left behind).

One label-smoothing draw is shared by the D-real and G targets. The draws
(label noise, the GP's alpha) come from ``generator`` unless the caller
injects them (``label_noise``, ``gp_alpha``), as the tests do with the JAX
step's own draws. Losses come back as one float32 tensor on the device:
[loss_d, loss_g (the GAN term), loss_l1, loss_gp, loss_per].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.losses.gan_loss import gan_loss
from tactile_gan_torch.losses.gradient_penalty import gradient_penalty
from tactile_gan_torch.losses.perceptual import l1_loss, vgg_perceptual_loss
from tactile_gan_torch.train.state import TrainState, set_lr

METRICS = ("loss_d", "loss_g", "loss_l1", "loss_gp", "loss_per")


def preprocess(src_u8: torch.Tensor, tgt_u8: torch.Tensor):
    """uint8 NHWC -> (source in [-1, 1], target in [0, 1]) float32."""
    return src_u8.float() / 255.0 * 2.0 - 1.0, tgt_u8.float() / 255.0


def _apply(opt: torch.optim.Optimizer, params, grads, lr: float) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    set_lr(opt, lr)
    opt.step()
    opt.zero_grad(set_to_none=True)


def build_train_step(cfg: TrainConfig, schedule: Callable[[int], float],
                     vgg_params: Optional[Dict[str, torch.Tensor]] = None):
    """Returns step(state, src_u8, tgt_u8, *, apply_gp, generator=None,
    label_noise=None, gp_alpha=None) -> the five losses (device tensor)."""
    if cfg.lambda_per != 0 and cfg.version != 1:
        raise NotImplementedError(
            "the version-2 perceptual loss (pan_loss) is not ported yet "
            "(ROADMAP.md, queue 1, 'Variants')")
    if cfg.lambda_per != 0 and vgg_params is None:
        raise ValueError("the v1 perceptual loss needs the VGG tower")
    mode, smoothing = cfg.loss, cfg.label_smoothing

    def step(state: TrainState, src_u8: torch.Tensor, tgt_u8: torch.Tensor,
             *, apply_gp: bool, generator: Optional[torch.Generator] = None,
             label_noise: Optional[torch.Tensor] = None,
             gp_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
        gen, disc = state.gen, state.disc
        real_a, real_b = preprocess(src_u8, tgt_u8)
        batch = real_a.shape[0]
        lr = schedule(state.step)

        fake = gen(real_a)

        # ---------------- D update ----------------
        fake_det = fake.detach()
        pred, _ = disc(torch.cat([real_a, real_a]),
                       torch.cat([fake_det, real_b]))
        pred_fake, pred_real = pred[:batch], pred[batch:]
        noise = None
        if smoothing:
            noise = label_noise if label_noise is not None else torch.randn(
                pred_real.shape, generator=generator, device=pred.device)
            noise = noise.to(pred.device)
        loss_d = (gan_loss(pred_fake, False, mode=mode)
                  + gan_loss(pred_real, True, mode=mode,
                             label_smoothing=smoothing, noise=noise)) / 2.0
        gp = torch.zeros((), device=pred.device)
        if apply_gp and cfg.lambda_gp != 0:
            alpha = gp_alpha if gp_alpha is not None else torch.rand(
                (batch, 1, 1, 1), generator=generator, device=pred.device)
            gp = gradient_penalty(lambda img, mask: disc(img, mask)[0],
                                  real_a, real_b, fake_det,
                                  alpha.to(pred.device), version=cfg.version,
                                  lambda_gp=cfg.lambda_gp)
        d_params = list(disc.parameters())
        _apply(state.opt_d, d_params,
               torch.autograd.grad(loss_d + gp, d_params), lr)

        # -------- G update, against the updated D --------
        pred_fake_g, _ = disc(real_a, fake)
        loss_gan = gan_loss(pred_fake_g, True, mode=mode,
                            for_discriminator=False,
                            label_smoothing=smoothing, noise=noise)
        loss_l1 = l1_loss(real_b, fake)
        loss_g = loss_gan + loss_l1 * cfg.lambda_a
        loss_per = torch.zeros((), device=pred.device)
        if cfg.lambda_per != 0:
            loss_per = vgg_perceptual_loss(vgg_params, real_b, fake,
                                           weights=cfg.w_per) * cfg.lambda_per
            loss_g = loss_g + loss_per
        g_params = list(gen.parameters())
        _apply(state.opt_g, g_params, torch.autograd.grad(loss_g, g_params),
               lr)
        state.step += 1
        return torch.stack([loss_d, loss_gan, loss_l1, gp,
                            loss_per]).detach().float()

    return step
