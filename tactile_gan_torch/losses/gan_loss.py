"""The four GAN objectives of ``tactile_gan_tpu/losses/gan_loss.py``: 'ls'
(MSE), 'ce' (BCE with logits), 'w' (Wasserstein +-mean) and 'hinge', with
one-sided label smoothing: the real target is clamp(1 + 0.02 * N(0, 1), 0,
1). The standard-normal draw is passed in (``noise``), so a caller can share
one draw between the discriminator's real target and the generator's, as
the training step does, and tests can inject the JAX step's own draw.
"""

from __future__ import annotations

from typing import Optional

import torch

VALID_MODES = ("ls", "ce", "w", "hinge")


def real_target(shape, *, label_smoothing: bool,
                noise: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """The target for "real": smoothed noise around 1, or ones."""
    if label_smoothing:
        if noise is None:
            raise ValueError("label smoothing needs a standard-normal draw")
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise of shape {tuple(noise.shape)} for a "
                             f"target of shape {tuple(shape)}")
        return torch.clamp(1.0 + 0.02 * noise.float(), 0.0, 1.0)
    return torch.ones(shape, dtype=torch.float32, device=device)


def gan_loss(logits: torch.Tensor, target_is_real: bool, *, mode: str,
             for_discriminator: bool = True, label_smoothing: bool = False,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar GAN loss of one prediction map; ``logits`` are already
    sigmoided when the discriminator was built with activation ('ls')."""
    if mode not in VALID_MODES:
        raise ValueError(f"Unexpected gan mode {mode}")
    x = logits.float()
    if mode in ("ls", "ce"):
        if target_is_real:
            target = real_target(x.shape, label_smoothing=label_smoothing,
                                 noise=noise, device=x.device)
        else:
            target = torch.zeros_like(x)
        if mode == "ls":
            return torch.mean(torch.square(x - target))
        return torch.mean(torch.clamp(x, min=0.0) - x * target
                          + torch.log1p(torch.exp(-torch.abs(x))))
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -torch.mean(torch.clamp(x - 1.0, max=0.0))
            return -torch.mean(torch.clamp(-x - 1.0, max=0.0))
        if not target_is_real:
            raise ValueError("The generator's hinge loss must be aiming for real")
        return -torch.mean(x)
    return -torch.mean(x) if target_is_real else torch.mean(x)
