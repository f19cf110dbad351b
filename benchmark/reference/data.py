"""The reference's data layer: the batches a training epoch hands to its
steps, worked out from the chart files alone.

A frozen copy of what the port's data layer computes
(``tactile_gan_torch/data/{pairing,dataset,host_aug}.py``): the sorted
file walk, the source-to-tactile path rewrite, the PIL decode, the epoch's
order (a numpy Generator seeded with ``seed + epoch`` shuffles it, the
short tail is dropped) and the joint host augmentation of each pair with a
Generator seeded ``(seed + 7919 * epoch, batch index, row)``: a horizontal
flip (p 0.5), then an affine (p 0.5: translate +-10 %, scale 0.8-1.2 per
axis, rotate +-15 degrees) through PIL, the source bilinear and the target
nearest, with a zero border. Imports numpy and PIL only.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".svg", ".tiff")
TRANSLATE_PCT = 0.1
SCALE_RANGE = (0.8, 1.2)
ROTATE_DEG = 15.0
P_FLIP = 0.5
P_AFFINE = 0.5
_PAD = 2  # covers every bilinear tap that straddles the image border
AUG_EPOCH_STRIDE = 7919


def list_images(img_dir: str) -> List[str]:
    images = []
    for root, _, fnames in sorted(os.walk(img_dir)):
        for fname in sorted(fnames):
            if fname.lower().endswith(IMG_EXTENSIONS):
                images.append(os.path.join(root, fname))
    return images


def tactile_path(source_path: str) -> str:
    dirname, basename = os.path.split(source_path)
    dirname = dirname.replace("source", "tactile")
    basename = basename.replace("s_", "t_").replace(".png", ".tiff")
    return os.path.join(dirname, basename)


def load_pair(path: str) -> Tuple[np.ndarray, np.ndarray]:
    from PIL import Image

    source = np.asarray(Image.open(path).convert("RGB"))
    tactile = np.asarray(Image.open(tactile_path(path)).convert("RGB"))
    return source, tactile


def inverse_affine_matrix_np(rng: np.random.Generator, h: int, w: int
                             ) -> np.ndarray:
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
    if rng.uniform() < P_FLIP:
        src_u8 = src_u8[:, ::-1]
        tgt_u8 = tgt_u8[:, ::-1]
    h, w = src_u8.shape[0], src_u8.shape[1]
    mat = inverse_affine_matrix_np(rng, h, w)
    if rng.uniform() < P_AFFINE:
        src_u8 = warp_pil(src_u8, mat, nearest=False)
        tgt_u8 = warp_pil(tgt_u8, mat, nearest=True)
    return np.ascontiguousarray(src_u8), np.ascontiguousarray(tgt_u8)


def epoch_batches(img_dir: str, batch_size: int, seed: int, epoch: int,
                  count: int, augment: bool = True
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The first ``count`` (source, target) uint8 (B, H, W, 3) batches of
    training epoch ``epoch`` (1 for the first) of a run seeded ``seed``,
    shuffled, the short tail dropped."""
    images = list_images(img_dir)
    order = np.arange(len(images))
    np.random.default_rng(seed + epoch).shuffle(order)
    order = order[: (len(order) // batch_size) * batch_size]
    out = []
    for ci in range(count):
        rows = []
        for row, i in enumerate(order[ci * batch_size:(ci + 1) * batch_size]):
            pair = load_pair(images[i])
            if augment:
                rng = np.random.default_rng(
                    (seed + AUG_EPOCH_STRIDE * epoch, ci, row))
                pair = augment_pair_np(pair[0], pair[1], rng)
            rows.append(pair)
        out.append((np.stack([p[0] for p in rows]),
                    np.stack([p[1] for p in rows])))
    return out
