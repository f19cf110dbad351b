"""Host-side joint augmentation of one uint8 (source, target) pair: a copy
of ``tactile_gan_tpu/data/host_aug.py`` (the JAX package's default
training augmentation), kept here so the port needs nothing of the JAX
package; tests hold the two byte-equal.

HorizontalFlip(p=.5) then Affine(translate +-10%, scale 0.8-1.2, rotate
+-15 deg, p=.5) applied jointly, albumentations-style: the source is
sampled bilinearly and rounded back to uint8, the target nearest-neighbour,
with a constant zero border. The warp runs through PIL's C affine
transform (it releases the GIL, so the decode pool overlaps the device
step). Randomness comes from a numpy Generator the caller seeds per
(run, epoch, batch, row).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

TRANSLATE_PCT = 0.1
SCALE_RANGE = (0.8, 1.2)
ROTATE_DEG = 15.0
P_FLIP = 0.5
P_AFFINE = 0.5
_PAD = 2  # covers every bilinear tap that straddles the image border


def inverse_affine_matrix_np(rng: np.random.Generator, h: int, w: int
                             ) -> np.ndarray:
    """Sample an albumentations-style affine; return the 2x3 matrix that
    maps output pixel coordinates (x, y) to source coordinates."""
    tx, ty = rng.uniform(-TRANSLATE_PCT, TRANSLATE_PCT, 2) * np.array([w, h])
    sx, sy = rng.uniform(SCALE_RANGE[0], SCALE_RANGE[1], 2)
    theta = np.deg2rad(rng.uniform(-ROTATE_DEG, ROTATE_DEG))
    cos, sin = np.cos(theta), np.sin(theta)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    inv_rot = np.array([[cos, sin], [-sin, cos]])
    inv_scale = np.array([[1.0 / sx, 0.0], [0.0, 1.0 / sy]])
    a = inv_scale @ inv_rot
    center = np.array([cx, cy])
    offset = -a @ (np.array([tx, ty]) + center) + center
    return np.concatenate([a, offset[:, None]], axis=1).astype(np.float32)


def warp_pil(img_u8: np.ndarray, mat: np.ndarray, *, nearest: bool
             ) -> np.ndarray:
    """Inverse warp by ``mat`` with a zero border. PIL evaluates the source
    at A @ (dst + 0.5) + t - 0.5, so the offsets are recentred; the 2-pixel
    zero pre-pad makes out-of-image taps read zeros instead of PIL's edge
    clamp."""
    from PIL import Image

    h, w = img_u8.shape[0], img_u8.shape[1]
    padded = np.zeros((h + 2 * _PAD, w + 2 * _PAD, img_u8.shape[2]), np.uint8)
    padded[_PAD:-_PAD, _PAD:-_PAD] = img_u8
    a, b, c = (float(v) for v in mat[0])
    d, e, f = (float(v) for v in mat[1])
    coeffs = (a, b, c - (a + b) * 0.5 + 0.5 + _PAD,
              d, e, f - (d + e) * 0.5 + 0.5 + _PAD)
    out = Image.fromarray(padded).transform(
        (w, h), Image.AFFINE, coeffs,
        resample=Image.NEAREST if nearest else Image.BILINEAR, fillcolor=0)
    return np.asarray(out)


def augment_pair_np(src_u8: np.ndarray, tgt_u8: np.ndarray,
                    rng: np.random.Generator
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Joint flip + affine on one uint8 pair; the result stays uint8."""
    if rng.uniform() < P_FLIP:
        src_u8 = src_u8[:, ::-1]
        tgt_u8 = tgt_u8[:, ::-1]
    h, w = src_u8.shape[0], src_u8.shape[1]
    mat = inverse_affine_matrix_np(rng, h, w)
    if rng.uniform() < P_AFFINE:
        src_u8 = warp_pil(src_u8, mat, nearest=False)
        tgt_u8 = warp_pil(tgt_u8, mat, nearest=True)
    return np.ascontiguousarray(src_u8), np.ascontiguousarray(tgt_u8)
