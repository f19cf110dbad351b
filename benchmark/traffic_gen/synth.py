"""A frozen copy of the port's synthetic chart generator
(``tactile_gan_torch/data/synth.py`` ``write_dataset``), kept with the
benchmark so that no change to the program can move its inputs: the same
seed gives the same files, byte for byte (``tests/test_benchmark_traffic.py``
holds the copy to the port's generator and to itself).

Sources are random 2D line charts (coloured lines, a grey grid and black
axes on white); targets are their tactile rendering, the same geometry
redrawn as white strokes on black, and its three grayscale components
(axes, grids, content).

    write_dataset(out, n_train=96, n_test=0, size=256, seed=0)

writes ``out/{train,test}/source/s_NNNN.png`` and
``out/{train,test}/tactile/t_NNNN.tiff`` plus ``t_NNNN_{axes,grids,
content}.tiff``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from PIL import Image, ImageDraw


def draw_chart(rng: np.random.Generator, size: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(source RGB, tactile RGB, components (H, W, 3): axes, grids,
    content), each uint8 of ``size`` x ``size``."""
    src = Image.new("RGB", (size, size), (255, 255, 255))
    d_src = ImageDraw.Draw(src)
    axes = Image.new("L", (size, size), 0)
    d_axes = ImageDraw.Draw(axes)
    grids = Image.new("L", (size, size), 0)
    d_grids = ImageDraw.Draw(grids)
    content = Image.new("L", (size, size), 0)
    d_content = ImageDraw.Draw(content)

    m = size // 8  # margin
    for i in range(1, 5):  # grid lines
        x = m + i * (size - 2 * m) // 5
        d_src.line([(x, m), (x, size - m)], fill=(200, 200, 200), width=1)
        d_grids.line([(x, m), (x, size - m)], fill=255, width=1)
        y = m + i * (size - 2 * m) // 5
        d_src.line([(m, y), (size - m, y)], fill=(200, 200, 200), width=1)
        d_grids.line([(m, y), (size - m, y)], fill=255, width=1)
    d_src.line([(m, m), (m, size - m)], fill=(0, 0, 0), width=2)  # axes
    d_src.line([(m, size - m), (size - m, size - m)], fill=(0, 0, 0), width=2)
    d_axes.line([(m, m), (m, size - m)], fill=255, width=3)
    d_axes.line([(m, size - m), (size - m, size - m)], fill=255, width=3)
    for _ in range(rng.integers(1, 3)):  # data lines
        color = tuple(int(c) for c in rng.integers(0, 200, 3))
        xs = np.linspace(m, size - m, 8)
        ys = rng.uniform(m, size - m, 8)
        pts = list(zip(xs.astype(int).tolist(), ys.astype(int).tolist()))
        d_src.line(pts, fill=color, width=2)
        d_content.line(pts, fill=255, width=4)

    comp = np.stack([np.array(axes), np.array(grids), np.array(content)], -1)
    # rgb tactile: white geometry on black, thickened strokes
    rgb = np.clip(comp.astype(np.int32).sum(-1), 0, 255).astype(np.uint8)
    rgb = np.stack([rgb] * 3, -1)
    return np.array(src), rgb, comp


def write_dataset(out: str, n_train: int = 64, n_test: int = 8,
                  size: int = 256, seed: int = 0) -> None:
    """Write ``n_train`` + ``n_test`` chart pairs under ``out`` from one
    generator seeded with ``seed`` (train first, then test)."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        sdir = os.path.join(out, split, "source")
        tdir = os.path.join(out, split, "tactile")
        os.makedirs(sdir, exist_ok=True)
        os.makedirs(tdir, exist_ok=True)
        for i in range(n):
            src, rgb, comp = draw_chart(rng, size)
            Image.fromarray(src).save(os.path.join(sdir, f"s_{i:04d}.png"))
            Image.fromarray(rgb).save(os.path.join(tdir, f"t_{i:04d}.tiff"))
            for c, name in enumerate(("axes", "grids", "content")):
                Image.fromarray(comp[:, :, c]).save(
                    os.path.join(tdir, f"t_{i:04d}_{name}.tiff"))
