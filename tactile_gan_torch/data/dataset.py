"""Paired dataset of (source RGB, tactile target) uint8 arrays.

File discovery and pairing are ``data/pairing.py``; decoding uses PIL,
imported where a pair is decoded so the package imports without it. Decoded
pairs are cached in RAM (``cache_decoded``) and frozen read-only, as in the
JAX package. A missing tactile file raises FileNotFoundError.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from tactile_gan_torch.data.pairing import list_images, tactile_paths_for


class PairedDataset:
    """Map-style dataset; ``load_pair(i)`` returns HWC uint8 arrays."""

    def __init__(self, img_dir: str, size: int = 256, mode: str = "test",
                 target: str = "rgb", cache_decoded: bool = True):
        self.img_dir = img_dir
        self.size = size
        self.mode = mode
        self.target = target
        self.images: List[str] = list_images(img_dir)
        self.cache_decoded = cache_decoded
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self.images)

    def load_pair(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.cache_decoded:
            hit = self._cache.get(i)
            if hit is not None:
                return hit
        from PIL import Image

        source = np.asarray(Image.open(self.images[i]).convert("RGB"))
        paths = tactile_paths_for(self.images[i], self.target)
        try:
            if self.target == "rgb":
                tactile = np.asarray(Image.open(paths["rgb"]).convert("RGB"))
            else:
                tactile = np.stack(
                    [np.asarray(Image.open(paths[k]).convert("L"))
                     for k in ("axes", "grids", "content")], axis=-1)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"missing tactile component(s) for {self.images[i]}: {paths}"
            ) from e
        if self.cache_decoded:
            source.setflags(write=False)
            tactile.setflags(write=False)
            # A racing decode of the same index stores an identical pair.
            self._cache[i] = (source, tactile)
        return source, tactile
