"""Spatial resizes on NHWC tensors.

- ``upsample_nearest2``: nn.Upsample(scale_factor=2), nearest (UNet++,
  SPADE).
- ``downsample_nearest``: F.interpolate(mode='nearest') to H/k x W/k for a
  whole k (SPADE's segmentation map at each of its scales).
- ``space_to_depth2`` / ``depth_to_space2``: 2x2 pixel blocks folded into
  channels and back (the ``--space_to_depth`` UNet++ row 0), in the JAX
  package's channel order.
- ``resize_bilinear``: F.interpolate(mode='bilinear', align_corners=False)
  without antialiasing, as ``tactile_gan_tpu/ops/resize.py`` computes it
  (half-pixel centres clamped to the image, separable H then W); the VGG
  perceptual loss resizes to 224x224 with it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return (x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
            .reshape(n, 2 * h, 2 * w, c))


def downsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/factor, W/factor, C), pixel (factor i,
    factor j) at (i, j): nearest's source pixel floor(i * H / (H/factor))
    where ``factor`` divides H and W."""
    n, h, w, c = x.shape
    if h % factor or w % factor:
        raise ValueError(f"{h}x{w} is not a multiple of {factor}")
    return x[:, ::factor, ::factor].contiguous()


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C); channel (2 dy + dx) * C + c."""
    n, h, w, c = x.shape
    return (x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h // 2, w // 2, 4 * c))


def depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``space_to_depth2``: (N, H, W, 4C) -> (N, 2H, 2W,
    C)."""
    n, h, w, c4 = x.shape
    c = c4 // 4
    return (x.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, 2 * h, 2 * w, c))


def _axis_weights(in_size: int, out_size: int, device):
    """Half-pixel-centre source indices and lerp weights for one axis."""
    scale = in_size / out_size
    centres = ((torch.arange(out_size, dtype=torch.float32, device=device)
                + 0.5) * scale - 0.5).clamp(0.0, in_size - 1)
    lo = centres.floor().long()
    hi = (lo + 1).clamp(max=in_size - 1)
    return lo, hi, centres - lo.float()


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N,H,W,C) -> (N,oh,ow,C) float32, bilinear, half-pixel centres, no
    antialiasing."""
    oh, ow = size
    x = x.float()
    lo, hi, f = _axis_weights(x.shape[1], oh, x.device)
    f = f[None, :, None, None]
    x = x[:, lo] * (1.0 - f) + x[:, hi] * f
    lo, hi, f = _axis_weights(x.shape[2], ow, x.device)
    f = f[None, None, :, None]
    return x[:, :, lo] * (1.0 - f) + x[:, :, hi] * f
