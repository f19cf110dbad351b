"""On-device preprocessing with the joint augmentation of ``--no-host_aug``
(``tactile_gan_tpu/data/augment.py``): per sample a horizontal flip
(p = 0.5), then an albumentations-style affine (p = 0.5: translate up to
10%, scale 0.8-1.2 per axis, rotate up to 15 degrees about the centre),
the source sampled bilinearly and the target mask nearest-neighbour, zero
outside the image; then the asymmetric normalization (source to [-1, 1],
target to [0, 1]).

The draws (flip flag, affine flag, 2x3 matrix per sample) come from a
``torch.Generator`` on the batch's device, or are injected (``AugmentDraws``)
as the tests inject the JAX keys' draws. Nothing here copies host memory
to the device or branches on a drawn value, so the stage captures inside
the training step's CUDA graph. The source coordinates are computed
elementwise (a00 * x + a01 * y + tx), so no matmul precision setting can
move them. The JAX package's gather-free ``_warp_dense`` is not ported: it
measured slower than this gather form there.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

TRANSLATE_PCT = 0.1
SCALE_RANGE = (0.8, 1.2)
ROTATE_DEG = 15.0
P_FLIP = 0.5
P_AFFINE = 0.5


class AugmentDraws(NamedTuple):
    """One batch's draws: flip (B,) bool, affine (B,) bool, and (B, 2, 3)
    float32 matrices mapping output pixel (x, y) to source coordinates."""
    flip: torch.Tensor
    affine: torch.Tensor
    matrix: torch.Tensor


def inverse_affine_matrix(translate: torch.Tensor, scale: torch.Tensor,
                          degrees: torch.Tensor, h: int, w: int
                          ) -> torch.Tensor:
    """(B, 2) translation fractions, (B, 2) scales and (B,) angles in
    degrees -> (B, 2, 3): p_in = S^-1 R^-1 (p_out - t - c) + c, c the image
    centre."""
    tx, ty = translate[:, 0] * w, translate[:, 1] * h
    sx, sy = scale[:, 0], scale[:, 1]
    theta = degrees * (math.pi / 180.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    a00, a01 = (1.0 / sx) * cos, (1.0 / sx) * sin
    a10, a11 = (1.0 / sy) * -sin, (1.0 / sy) * cos
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    ox = -(a00 * (tx + cx) + a01 * (ty + cy)) + cx
    oy = -(a10 * (tx + cx) + a11 * (ty + cy)) + cy
    return torch.stack([torch.stack([a00, a01, ox], -1),
                        torch.stack([a10, a11, oy], -1)], 1)


def draw_augment(batch: int, h: int, w: int, generator: torch.Generator,
                 device) -> AugmentDraws:
    """Seven uniforms a sample from ``generator``: the flip and affine
    flags, then the translation, scale and angle."""
    u = torch.rand((batch, 7), generator=generator, device=device)
    lo_s, hi_s = SCALE_RANGE
    return AugmentDraws(
        u[:, 0] < P_FLIP, u[:, 1] < P_AFFINE,
        inverse_affine_matrix(TRANSLATE_PCT * (2.0 * u[:, 2:4] - 1.0),
                              lo_s + (hi_s - lo_s) * u[:, 4:6],
                              ROTATE_DEG * (2.0 * u[:, 6] - 1.0), h, w))


def warp(img: torch.Tensor, matrix: torch.Tensor, *,
         nearest: bool) -> torch.Tensor:
    """Inverse-warp (B, H, W, C) float32 images by (B, 2, 3) matrices:
    bilinear, or nearest (round half to even) for masks; zero outside."""
    b, h, w, c = img.shape
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    m = matrix[:, :, :, None, None]  # (B, 2, 3, 1, 1)
    sx = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]  # (B, H, W)
    sy = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    flat = img.reshape(b, h * w, c)

    def sample(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx.reshape(b, h * w, 1)
                            .expand(b, h * w, c)).reshape(b, h, w, c)
        return torch.where(inb[..., None], vals, 0.0)

    if nearest:
        return sample(torch.round(sx).long(), torch.round(sy).long())
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    x0, y0 = x0f.long(), y0f.long()
    fx, fy = (sx - x0f)[..., None], (sy - y0f)[..., None]
    top = sample(x0, y0) * (1 - fx) + sample(x0 + 1, y0) * fx
    bot = sample(x0, y0 + 1) * (1 - fx) + sample(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def augment_pair(src: torch.Tensor, tgt: torch.Tensor, draws: AugmentDraws
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The joint flip, then the joint affine, of float [0, 1] NHWC
    batches."""
    flip = draws.flip[:, None, None, None]
    src = torch.where(flip, torch.flip(src, dims=(2,)), src)
    tgt = torch.where(flip, torch.flip(tgt, dims=(2,)), tgt)
    aff = draws.affine[:, None, None, None]
    src = torch.where(aff, warp(src, draws.matrix, nearest=False), src)
    tgt = torch.where(aff, warp(tgt, draws.matrix, nearest=True), tgt)
    return src, tgt


def preprocess_batch(src_u8: torch.Tensor, tgt_u8: torch.Tensor, *,
                     augment: bool,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[AugmentDraws] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC -> (source in [-1, 1], target in [0, 1]) float32; with
    ``augment``, the joint augmentation first, on ``draws`` or on draws
    from ``generator``."""
    src = src_u8.float() / 255.0
    tgt = tgt_u8.float() / 255.0
    if augment:
        if draws is None:
            draws = draw_augment(src.shape[0], src.shape[1], src.shape[2],
                                 generator, src.device)
        src, tgt = augment_pair(src, tgt, draws)
    return src * 2.0 - 1.0, tgt
