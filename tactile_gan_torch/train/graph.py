"""The training step as CUDA graphs, one per gradient-penalty variant: the
counterpart of ``jax.jit(_step, static_argnames=("apply_gp",))``
(``tactile_gan_tpu/train/step.py``).

``GraphedStep`` wraps a ``TrainStep`` and its state. The first step of each
variant runs eager on a side stream (a real step: it builds the kernels and
Adam's state) and the variant is captured right after it; every later step
of that variant copies its batch into the static inputs and replays. Both
graphs share one memory pool: they never run at the same time, and the
only pool tensor read after a replay, its loss vector, is cloned at once.
Outside the graph, around each replay, the wrapper sets the schedule's rate
(filled into Adam's device rate tensor), counts the step and keeps what a
replay cannot:

- draws: the trainer's CUDA generator is registered with each graph, so
  every replay draws on from the generator's current offset, as an eager
  step would (torch refuses to capture a draw from a generator that is not
  registered);
- launch counters: the kernel wrappers count Python calls, and a capture
  makes the calls but launches nothing, so each variant's counts (all
  launches, and those on bfloat16 activations) are taken out of the
  counters at capture and added back on every replay;
- weight relayouts: kernel B's cache is keyed by the weight's version
  counter, which a replay does not move, so it is cleared after every
  replay (under capture it is neither read nor written).

A capture that fails raises; nothing falls back to eager launches. In a
parallel run the step's all-reduces (and a split conv's gathers) are
captured with it: NCCL's collectives capture into a graph, gloo's do not,
so the trainer refuses a graphed step over gloo on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Sequence, Tuple

import torch

from tactile_gan_torch.ops.kernels import conv3x3 as _conv
from tactile_gan_torch.ops.kernels import conv3x3_wgrad as _wgrad
from tactile_gan_torch.ops.kernels import instance_norm as _norm
from tactile_gan_torch.train.state import TrainState
from tactile_gan_torch.train.step import TrainStep

# Each kernel wrapper's launch counter, as (module, wrapper name): read
# through the module, so a wrapper replaced there is the one counted.
LAUNCH_COUNTERS = ((_norm, "instance_norm_act"), (_norm, "backward_kernel"),
                   (_conv, "conv3x3"), (_conv, "dgrad_kernel"),
                   (_wgrad, "conv3x3_wgrad"), (_conv, "conv3x3_p1"),
                   (_conv, "conv3x3_p1_h"))


def read_launches(count: str = "launches") -> Tuple[int, ...]:
    """Each wrapper's ``count``: "launches", or "bf16_launches" (those on
    bfloat16 activations; 0 for a wrapper that keeps none)."""
    return tuple(getattr(getattr(m, name), count, 0)
                 for m, name in LAUNCH_COUNTERS)


def add_launches(counts: Sequence[int], sign: int = 1,
                 count: str = "launches") -> None:
    for (m, name), n in zip(LAUNCH_COUNTERS, counts):
        fn = getattr(m, name)
        setattr(fn, count, getattr(fn, count, 0) + sign * n)


class LaunchCarry:
    """Moves the counts a capture made into its replays: ``with carry:``
    around the capture takes them out of the counters into ``counts``
    (and ``bf16_counts``); ``replayed()`` adds them once."""

    def __init__(self):
        self.counts: Tuple[int, ...] = tuple(0 for _ in LAUNCH_COUNTERS)
        self.bf16_counts: Tuple[int, ...] = self.counts
        self._before = (self.counts, self.counts)

    def __enter__(self) -> "LaunchCarry":
        self._before = (read_launches(), read_launches("bf16_launches"))
        return self

    def __exit__(self, *exc) -> None:
        self.counts, self.bf16_counts = (
            tuple(a - b for a, b in zip(read_launches(count), before))
            for count, before in zip(("launches", "bf16_launches"),
                                     self._before))
        self.replayed(-1)

    def replayed(self, sign: int = 1) -> None:
        add_launches(self.counts, sign)
        add_launches(self.bf16_counts, sign, "bf16_launches")


@dataclasses.dataclass
class Captured:
    graph: "torch.cuda.CUDAGraph"
    losses: torch.Tensor      # the graph's output, rewritten by each replay
    launches: LaunchCarry
    capture_s: float          # host seconds of the capture


class GraphedStep:
    """``step(src_u8, tgt_u8, *, apply_gp)`` -> the five losses, a tensor of
    its own; advances ``state.step`` by one. Every batch has the shape and
    dtype of the first."""

    def __init__(self, train_step: TrainStep, state: TrainState,
                 generator: torch.Generator):
        if generator.device.type != "cuda":
            raise ValueError("GraphedStep needs a CUDA generator, got one on "
                             f"{generator.device}")
        self.train_step = train_step
        self.state = state
        self.generator = generator
        self.captured: Dict[bool, Captured] = {}
        self._src = self._tgt = None  # the static inputs, from the first batch
        self._side = torch.cuda.Stream(generator.device)
        self._pool = torch.cuda.graph_pool_handle()

    def _stage(self, src: torch.Tensor, tgt: torch.Tensor) -> None:
        """Copy the batch into the static inputs (on the current stream)."""
        if self._src is None:
            self._src, self._tgt = (
                torch.empty(t.shape, dtype=t.dtype,
                            device=self.generator.device) for t in (src, tgt))
        for new, static in ((src, self._src), (tgt, self._tgt)):
            if new.shape != static.shape or new.dtype != static.dtype:
                raise ValueError(
                    f"GraphedStep: a batch of {new.dtype} {tuple(new.shape)} "
                    f"does not match the captured {static.dtype} "
                    f"{tuple(static.shape)}")
            static.copy_(new)

    def _compute(self, apply_gp: bool) -> torch.Tensor:
        return self.train_step.compute(self.state, self._src, self._tgt,
                                       apply_gp=apply_gp,
                                       generator=self.generator)

    def _eager_then_capture(self, apply_gp: bool) -> torch.Tensor:
        current = torch.cuda.current_stream()
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            losses = self._compute(apply_gp)
        current.wait_stream(self._side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with LaunchCarry() as carry, torch.cuda.graph(graph, pool=self._pool):
            static = self._compute(apply_gp)
        self.captured[apply_gp] = Captured(graph, static, carry,
                                           time.perf_counter() - t0)
        return losses

    def __call__(self, src_u8: torch.Tensor, tgt_u8: torch.Tensor, *,
                 apply_gp: bool) -> torch.Tensor:
        self._stage(src_u8, tgt_u8)
        self.train_step.set_lr(self.state)
        cap = self.captured.get(apply_gp)
        if cap is None:
            losses = self._eager_then_capture(apply_gp)
        else:
            cap.graph.replay()
            cap.launches.replayed()
            _conv.invalidate_relayouts()
            losses = cap.losses.clone()
        self.state.step += 1
        return losses
