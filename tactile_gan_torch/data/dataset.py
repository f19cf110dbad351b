"""Paired dataset of (source RGB, tactile target) uint8 arrays, and the
training batches (``tactile_gan_tpu/data/dataset.py``).

File discovery and pairing are ``data/pairing.py``; decoding uses PIL,
imported where a pair is decoded so the package imports without it. Decoded
pairs are cached in RAM (``cache_decoded``) and frozen read-only, as in the
JAX package. A missing tactile file raises FileNotFoundError.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator, List, Tuple

import numpy as np

from tactile_gan_torch.data.host_aug import augment_pair_np
from tactile_gan_torch.data.pairing import list_images, tactile_paths_for


class PairedDataset:
    """Map-style dataset; ``load_pair(i)`` returns HWC uint8 arrays."""

    def __init__(self, img_dir: str, size: int = 256, mode: str = "test",
                 target: str = "rgb", cache_decoded: bool = True,
                 aug: bool = False):
        self.img_dir = img_dir
        self.size = size
        self.mode = mode
        self.aug = aug and mode == "train"
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

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_last: bool = False, threads: int = 8,
                pad_to_batch: bool = False, host_augment: bool = False,
                augment_seed: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        """Yield (source u8 (B,H,W,3), target u8 (B,H,W,3), valid_count),
        as the JAX package's ``batches`` does: the order shuffled by a numpy
        Generator seeded with ``seed``; ``drop_last`` drops the short final
        batch, ``pad_to_batch`` pads it by repeating its last pair. Decoding
        fans out over ``threads`` workers and one staging worker assembles
        the next batch while the caller consumes this one. With
        ``host_augment`` each pair is augmented with a Generator seeded
        (augment_seed, batch index, row)."""
        order = np.arange(len(self.images))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        if drop_last:
            order = order[: (len(order) // batch_size) * batch_size]
        if len(order) == 0:
            return iter(())
        chunks = [order[i:i + batch_size]
                  for i in range(0, len(order), batch_size)]

        def generator():
            with cf.ThreadPoolExecutor(max_workers=max(1, threads)) as decode, \
                    cf.ThreadPoolExecutor(max_workers=1) as staging:

                def assemble(chunk_i: int, idx: np.ndarray):
                    valid = len(idx)
                    idx = list(idx)
                    if pad_to_batch and valid < batch_size:
                        idx += [idx[-1]] * (batch_size - valid)

                    def load_one(args):
                        row, i = args
                        pair = self.load_pair(i)
                        if not host_augment:
                            return pair
                        rng = np.random.default_rng((augment_seed, chunk_i, row))
                        return augment_pair_np(pair[0], pair[1], rng)

                    pairs = list(decode.map(load_one, enumerate(idx)))
                    return (np.stack([p[0] for p in pairs]),
                            np.stack([p[1] for p in pairs]), valid)

                pending = staging.submit(assemble, 0, chunks[0])
                for ci, nxt in enumerate(chunks[1:], start=1):
                    ready = pending.result()
                    pending = staging.submit(assemble, ci, nxt)
                    yield ready
                yield pending.result()

        return generator()
