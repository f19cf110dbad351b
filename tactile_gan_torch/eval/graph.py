"""The serving programs as CUDA graphs: the counterpart of the JAX runner's
``_jits_for`` and ``_chain_for`` (``tactile_gan_tpu/eval/runner.py``).

A ``ServingPrograms`` holds one program per (mode, batch shape) of one
generator function (a loaded generator, or two of them chained), each the
JAX runner's program of that mode:

- ``f32``: normalize the uint8 upload, then the generator;
- ``u8``: the same, then the bit-exact uint8 quantize;
- ``u8_eval``: the same, then the four fuzzy-metric sums against the
  uploaded uint8 target.

On the card a program's first call runs eager on a side stream (a real
call: it warms cuDNN's algorithm choice and the allocator, and its outputs
are returned), and the program is captured right after it under inference
mode, on static inputs cloned from that batch. Every later call copies its
batch into the static inputs, replays and clones the graph's outputs on the
replay's stream, so the caller holds tensors of its own while the next
replay rewrites the graph's. The programs of one ``ServingPrograms`` share
one memory pool: they never run at the same time. Nothing else may touch
the card while a program is captured. A capture or a replay that fails
raises; nothing falls back to eager launches. The kernel wrappers' launch
counts of a capture move into its replays (``LaunchCarry``), and kernel B's
weight relayouts are recorded into the graph (frozen serving weights: no
relayout cache to clear). On the CPU, or with ``graphed=False``, each
program runs the same function eagerly.

The programs belong to the forward that serves them
(``eval/runner.py``: ``GeneratorForward.programs``, and
``chain_programs`` for two stages chained), so they die with it: there is
no module-level cache.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from tactile_gan_torch.train.graph import LaunchCarry

MODES = ("f32", "u8", "u8_eval")


def normalize_u8(src_u8: torch.Tensor) -> torch.Tensor:
    """uint8 image -> [-1, 1] float32, the training preprocessing."""
    return src_u8.float() / 255.0 * 2.0 - 1.0


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """round_half_even(clip(x, 0, 1) * 255) in float64: bit-exact with the
    host writers' ``visualize._u8`` (torch.round rounds half to even)."""
    return torch.round(torch.clamp(x.double(), 0.0, 1.0) * 255.0).to(torch.uint8)


def fuzzy_sums(out: torch.Tensor, tgt_u8: torch.Tensor) -> torch.Tensor:
    """Per-image (B, 4) float64: [sum(min(o, r)), sum(r), sum(o*r),
    sum(o^2 + r^2)], the four sums of ``eval_pair``'s fuzzy branch, with r
    the float32 target k/255 as the host computes it."""
    o = out.double()
    r = (tgt_u8.float() / 255.0).double()
    dims = tuple(range(1, o.dim()))
    return torch.stack([torch.minimum(o, r).sum(dims), r.sum(dims),
                        (o * r).sum(dims), (o * o + r * r).sum(dims)], dim=1)


@dataclasses.dataclass
class Program:
    inputs: Tuple[torch.Tensor, ...] = ()   # the static inputs (card only)
    outputs: Tuple[torch.Tensor, ...] = ()  # rewritten by each replay
    graph: Optional["torch.cuda.CUDAGraph"] = None
    launches: Optional[LaunchCarry] = None
    capture_s: float = 0.0                  # host seconds of the capture


class ServingPrograms:
    """``programs(mode, src_u8, tgt_u8=None)`` -> the program's outputs, a
    tuple of tensors of their own: the image (float32 for ``f32``, uint8
    otherwise) and, for ``u8_eval``, the (B, 4) float64 sums against
    ``tgt_u8``. The batch lies on ``device``."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 device, graphed: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.graphed = graphed and self.device.type == "cuda"
        self.programs: Dict[tuple, Program] = {}
        if self.graphed:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()

    @property
    def captures(self) -> int:
        return sum(p.graph is not None for p in self.programs.values())

    def _compute(self, mode: str, src_u8: torch.Tensor,
                 tgt_u8: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
        out = self.fn(normalize_u8(src_u8))
        if mode == "f32":
            return (out,)
        if mode == "u8":
            return (quantize_u8(out),)
        return quantize_u8(out), fuzzy_sums(out, tgt_u8)

    def _eager_then_capture(self, key: tuple, batch: Tuple[torch.Tensor, ...]
                            ) -> Tuple[torch.Tensor, ...]:
        inputs = tuple(t.clone() for t in batch)
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            first = self._compute(key[0], *inputs)
        current.wait_stream(self._side)
        for t in first:  # made on the side stream, read on the current one
            t.record_stream(current)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with LaunchCarry() as carry, torch.cuda.graph(graph, pool=self._pool):
            outputs = self._compute(key[0], *inputs)
        self.programs[key] = Program(inputs, outputs, graph, carry,
                                     time.perf_counter() - t0)
        return first

    def _stage(self, prog: Program, batch: Tuple[torch.Tensor, ...]) -> None:
        """Copy the batch into the static inputs (on the current stream)."""
        for static, new in zip(prog.inputs, batch):
            static.copy_(new)

    def _take(self, prog: Program) -> Tuple[torch.Tensor, ...]:
        """The replay's outputs, cloned on the current stream before the
        next replay rewrites them."""
        return tuple(t.clone() for t in prog.outputs)

    @staticmethod
    def _key(mode: str, batch: Tuple[torch.Tensor, ...]) -> tuple:
        return (mode,) + tuple((tuple(t.shape), t.dtype) for t in batch)

    def will_capture(self, mode: str, src_u8: torch.Tensor,
                     tgt_u8: Optional[torch.Tensor] = None) -> bool:
        """Whether this call would capture: the caller keeps every other
        thread off the card until it returns."""
        batch = (src_u8,) if tgt_u8 is None else (src_u8, tgt_u8)
        return self.graphed and self._key(mode, batch) not in self.programs

    def __call__(self, mode: str, src_u8: torch.Tensor,
                 tgt_u8: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
        if mode not in MODES:
            raise ValueError(f"unknown serving program {mode!r}; one of "
                             f"{MODES}")
        if (mode == "u8_eval") != (tgt_u8 is not None):
            raise ValueError(f"program {mode!r}: the target is given only "
                             "to u8_eval")
        batch = (src_u8,) if tgt_u8 is None else (src_u8, tgt_u8)
        key = self._key(mode, batch)
        with torch.inference_mode():
            prog = self.programs.get(key)
            if not self.graphed:
                if prog is None:
                    self.programs[key] = Program()
                return self._compute(mode, *batch)
            if prog is None:
                return self._eager_then_capture(key, batch)
            self._stage(prog, batch)
            prog.graph.replay()
            prog.launches.replayed()
            return self._take(prog)
