"""WGAN-GP gradient penalty (``tactile_gan_tpu/losses/gradient_penalty.py``).

The penalty differentiates sum(D(A, interp)) with respect to the
interpolates with ``torch.autograd.grad(create_graph=True)``, so the result
is itself differentiable with respect to D's parameters (second order: D
runs on autograd-native ops only). The mixing coefficient alpha is per
sample, U[0, 1), remapped to U[0.5, 1) for version 2; it is passed in
(``alpha``), so tests can inject the JAX step's own draw. The +1e-16 inside
the norm is kept from the reference.
"""

from __future__ import annotations

from typing import Callable

import torch


def gp_interpolates(real_mask: torch.Tensor, fake_mask: torch.Tensor,
                    alpha: torch.Tensor, version: int = 2) -> torch.Tensor:
    """alpha * real + (1 - alpha) * fake, alpha of shape (B, 1, 1, 1)."""
    if version == 2:
        alpha = (alpha + 1.0) / 2.0
    return alpha * real_mask + (1.0 - alpha) * fake_mask


def gp_penalty(grads: torch.Tensor, constant: float = 1.0,
               lambda_gp: float = 1.0) -> torch.Tensor:
    """mean((||grad per sample|| - constant)^2) * lambda_gp."""
    flat = (grads + 1e-16).reshape(grads.shape[0], -1)
    return torch.mean(torch.square(flat.norm(dim=1) - constant)) * lambda_gp


def gradient_penalty(disc_fn: Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor],
                     real_img: torch.Tensor, real_mask: torch.Tensor,
                     fake_mask: torch.Tensor, alpha: torch.Tensor,
                     version: int = 2, constant: float = 1.0,
                     lambda_gp: float = 1.0) -> torch.Tensor:
    """disc_fn(img, mask) -> patch logits; returns the scalar penalty."""
    interp = gp_interpolates(real_mask, fake_mask, alpha,
                             version).detach().requires_grad_(True)
    out = disc_fn(real_img, interp).float().sum()
    (grads,) = torch.autograd.grad(out, interp, create_graph=True)
    return gp_penalty(grads, constant, lambda_gp)
