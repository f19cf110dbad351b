"""Input prefetch: the counterpart of the JAX loop's ``_h2d`` staging
(``tactile_gan_tpu/train/loop.py``), which puts batch k+1 on the device
while step k runs.

``Prefetcher(device)(batches)`` takes the dataset's (source u8, target u8,
valid) host batches and yields them in the same order with the arrays as
tensors on ``device``. On the card each batch is copied into one of two
pinned host buffers, and its host-to-device copy is enqueued on a copy
stream of its own, with an event behind it, before the caller's step on the
batch before it is enqueued. The compute stream waits on that event, not
the host; the host waits only before refilling a pinned buffer, for the
copy that read it two batches earlier. On the CPU the arrays are wrapped
as tensors, unchanged.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

Batch = Tuple[np.ndarray, np.ndarray, int]


class Prefetcher:

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._pinned = [None, None]  # (src, tgt) pinned host tensors
            self._read = [None, None]    # the event after each one's copy
            self._slot = 0

    def _pinned_slot(self, src: np.ndarray, tgt: np.ndarray):
        i = self._slot
        self._slot ^= 1
        if self._read[i] is not None:
            self._read[i].synchronize()  # the copy that read it is done
        buf = self._pinned[i]
        if buf is None:  # every batch has the first one's shape
            buf = self._pinned[i] = tuple(
                torch.empty(a.shape, dtype=torch.uint8, pin_memory=True)
                for a in (src, tgt))
        for b, a in zip(buf, (src, tgt)):
            b.numpy()[...] = a
        return i, buf

    def _stage(self, batch: Batch):
        """Enqueue the batch's copy; returns (device tensors, event, valid)."""
        src, tgt, valid = batch
        i, buf = self._pinned_slot(src, tgt)
        with torch.cuda.stream(self._stream):
            dev = tuple(b.to(self.device, non_blocking=True) for b in buf)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._read[i] = event
        return dev, event, valid

    def _ready(self, staged):
        dev, event, valid = staged
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for t in dev:  # allocated on the copy stream, used on this one
            t.record_stream(compute)
        return dev[0], dev[1], valid

    def __call__(self, batches: Iterable[Batch]
                 ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, int]]:
        if not self._cuda:
            for src, tgt, valid in batches:
                yield torch.from_numpy(src), torch.from_numpy(tgt), valid
            return
        staged = None
        for batch in batches:
            nxt = self._stage(batch)
            if staged is not None:
                yield self._ready(staged)
            staged = nxt
        if staged is not None:
            yield self._ready(staged)
