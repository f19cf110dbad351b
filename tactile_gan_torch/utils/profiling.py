"""Where the device time of a serving forward or a training step goes.

    python -m tactile_gan_torch.utils.profiling [--gen G] [--batch 1 4] [--reps 5]
    python -m tactile_gan_torch.utils.profiling --train [--gen G] [--reps 3]

Builds the ``--gen`` generator (UNet++, UNet, BCDUNet or SPADE; UNet++ by
default) at nf=64 and 256x256 with N(0, 0.02) weights from ``--seed`` and
the default bfloat16 compute. The default mode runs
``--reps`` forwards per batch size under ``torch.profiler``, then the
``u8_eval`` serving program (``eval/graph.py``: normalize, the forward, the
uint8 quantize and the metric sums) at the same batch, run op by op and as
the runner dispatches it (a CUDA graph replay and its copies, with the
capture's host seconds); ``--train``
runs ``--reps`` steady-state training steps at the defaults (batch 4, the
PatchGAN discriminator, GP, the v1 perceptual loss on the seeded VGG
fallback, label smoothing, Adam) on a fixed random batch, twice: as the
trainer runs them (``train/graph.py``'s replays, after one eager step and
the capture) and through the eager step, each after two warm-up steps.
Each prints the host wall time of one forward or step, the device time of
one summed by kernel family (kernels A and C, B forward and B-dx, D,
library convs, everything else) and for the kernels that took the most,
the share of the profiled window in which no kernel ran, and the kernel
and graph launches the host made a step; ``--train`` also the peak device
memory up to the graphed profile and, from the step's phase markers, the
device ms of each phase, by kernel family and for its top kernels
(``phases``). Needs a CUDA device; the JSON goes to ``--out``. A
profile that records no device kernel reports the device times as not
measured instead of zeros.

The trainer's hooks live here too: ``trace`` (``--profile_dir``, a
``torch.profiler`` trace of the first epoch) and ``nan_guard``
(``--debug_nans``, a check of each step's losses); and the program's own
spans: ``span`` (a ``record_function`` range: ``train.*`` in the trainer,
``data.*`` in the prefetcher, ``graph.capture``) and ``phase``, the same
range plus a marker kernel on the card (``PHASES``, in
``TrainStep.compute``). A CUDA graph replays the markers with the step, so
``phase_walk`` gives each replayed kernel its phase. With no profiler
running a span opens no range; the markers run regardless, so a capture
made without a profiler carries them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import time
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Tuple

import torch

from tactile_gan_torch.ops.kernels import marks

if TYPE_CHECKING:
    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.train.graph import GraphedStep
    from tactile_gan_torch.train.state import TrainState
    from tactile_gan_torch.train.step import TrainStep

TOP_KERNELS = 12  # kernel names listed by device time

# The port's own kernels, matched as whole identifiers, so that no name of
# PyTorch's own kernels that merely contains one of these counts.
OWN_FAMILIES = (
    ("kernel_a", ("in_act_fwd_kernel",)),
    ("kernel_c", ("in_act_bwd_kernel",)),
    ("kernel_b", ("conv3x3_fwd_sm90_kernel", "conv3x3_f32_kernel")),
    ("kernel_b_dx", ("conv3x3_dgrad_sm90_kernel", "conv3x3_dgrad_f32_kernel")),
    ("kernel_d", ("conv3x3_wgrad_sm90_kernel", "wgrad_f32_kernel",
                  "wgrad_reduce_kernel")),
    ("kernel_e", ("conv3x3_p1_sm90_kernel",)),
    # conv3x3.cu's tail: kernel E off the wgmma body, and B and B-dx at
    # widths off their own entries (UNet++ at nf 8, 12, 24).
    ("conv3x3_tail", ("conv3x3_p1_bf16_kernel", "conv3x3_p1_f32_kernel")),
)
_OWN = [(fam, re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(keys) + r")\b"))
        for fam, keys in OWN_FAMILIES]
# Substrings of the library's convolution kernels.
LIBRARY_CONV = ("conv", "xmma", "cudnn", "cutlass", "gemm", "sm90_", "sm80_")
# The host-side calls that launch device work: a kernel, or a whole graph.
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch")
# The host-side calls that enqueue a copy (counted apart from launches).
HOST_COPIES = ("cudaMemcpyAsync",)
# Device copies between host and device: the prefetcher's, on a stream of
# its own, and an epoch's loss means; no phase of the step holds them.
HOST_DEVICE_COPIES = ("Memcpy HtoD", "Memcpy DtoH")

PHASES = (
    ("step.prep", "tg_mark_prep"),
    ("step.g_fwd", "tg_mark_g_fwd"),
    ("step.d_fwd", "tg_mark_d_fwd"),
    ("step.gp", "tg_mark_gp"),
    ("step.d_bwd", "tg_mark_d_bwd"),
    ("step.d_adam", "tg_mark_d_adam"),
    ("step.g_dfwd", "tg_mark_g_dfwd"),
    ("step.g_loss", "tg_mark_g_loss"),
    ("step.g_bwd", "tg_mark_g_bwd"),
    ("step.g_adam", "tg_mark_g_adam"),
)
"""The training step's phases in order (``TrainStep.compute``), each a
(range name, marker kernel) pair; a phase runs from its marker to the
next, and ``END_MARK`` closes the step:

- ``step.prep``: the augment draws and ``preprocess_batch``;
- ``step.g_fwd``: ``fake = gen(real_a)``;
- ``step.d_fwd``: D on the stacked (fake, real) pair, the label noise,
  ``loss_d``;
- ``step.gp``: alpha and ``gradient_penalty`` (D on the interpolate and its
  ``create_graph`` gradient); absent when the step applies no GP;
- ``step.d_bwd``: ``autograd.grad(loss_d + gp, d_params)``, the GP's
  double backward included, and the gradients' reduce;
- ``step.d_adam``: D's Adam update;
- ``step.g_dfwd``: D's forward for G (in v2 the stacked forward of
  ``pan_loss``);
- ``step.g_loss``: the GAN term, L1 and the perceptual term (in v1 the VGG
  forward);
- ``step.g_bwd``: ``autograd.grad(loss_g, g_params)`` and the reduce;
- ``step.g_adam``: G's Adam update, the loss stack and its all-reduce.
"""
END_MARK = "tg_mark_end"
_MARK_OF = dict(PHASES)
_PHASE_OF = {m: name for name, m in PHASES}


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` a ``record_function`` range named ``name``
    while a profiler runs, else nothing. A range's enter and exit are torch
    op calls, which let go of the GIL; with the decode threads busy, taking
    it back cost about 2 ms a range (an 8-core CPU host, four busy Python
    threads), so no range is opened that no profiler records."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def phase(name: str, like: torch.Tensor):
    """The step's phase ``name`` (one of ``PHASES``): its range, and its
    marker kernel on the current stream where ``like`` is on the card."""
    with span(name):
        marks.mark(_MARK_OF[name], like)
        yield


def end_step(like: torch.Tensor) -> None:
    """Close the step's last phase on the card (``END_MARK``)."""
    marks.mark(END_MARK, like)


# A model's layer marks, none of them a phase's: ``layer``'s entry and exit
# in the forward, ``tg_mark_<layer>_in`` and ``_out``, and each one's twin
# in the backward, where the gradient passes the same point: the exit's
# twin (``_bwd_out``) where the layer's backward starts, the entry's
# (``_bwd_in``) where it ends. The model names its layer
# (``models/spade.py``); ``csrc/phase_marks.cu`` ``TG_LAYERS`` lists the
# layers that have markers. Inside a generator, the forward's lie in
# ``step.g_fwd`` and the backward's in ``step.g_bwd``.


class _LayerMark(torch.autograd.Function):
    """Passes ``x``; launches ``symbol`` in the forward and ``twin`` in the
    backward, on the current stream where the tensor is on the card."""

    @staticmethod
    def forward(ctx, x, symbol, twin):
        ctx.twin = twin
        marks.mark(symbol, x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        marks.mark(ctx.twin, g)
        return g, None, None


def layer_marks(layer: str) -> Tuple[str, ...]:
    """The four markers of ``layer``: in, out, bwd_out, bwd_in."""
    return tuple(f"tg_mark_{layer}_{w}"
                 for w in ("in", "out", "bwd_out", "bwd_in"))


def layer_mark(x: torch.Tensor, layer: str, where: str) -> torch.Tensor:
    """``x``, marked as ``layer``'s entry (``where`` "in") or exit ("out")
    in the forward and in the backward."""
    if where not in ("in", "out"):
        raise ValueError(f"where is 'in' or 'out', got {where!r}")
    return _LayerMark.apply(x, f"tg_mark_{layer}_{where}",
                            f"tg_mark_{layer}_bwd_{where}")


def phase_walk(kernels: Iterable[Tuple[str, float, float]]
               ) -> Dict[str, Dict[str, float]]:
    """Device time of each phase by kernel name, from the (name, start,
    end) of a window's device operations: walked in order of start, each
    goes to the phase of the last marker before it (a marker to its own
    phase), none after ``END_MARK`` or before the first marker; copies
    between host and device are skipped. Empty where no marker ran."""
    out: Dict[str, Dict[str, float]] = {}
    current = None
    for name, s, e in sorted(kernels, key=lambda k: k[1]):
        if name.startswith(HOST_DEVICE_COPIES):
            continue
        if name == END_MARK:
            current = None
            continue
        current = _PHASE_OF.get(name, current)
        if current is not None:
            by_name = out.setdefault(current, {})
            by_name[name] = by_name.get(name, 0.0) + (e - s)
    return out


def phase_breakdown(kernels: List[Tuple[str, float, float]], reps: int
                    ) -> Optional[Dict[str, object]]:
    """Device ms a rep of each phase that ran, in the step's order, by
    kernel family and for its top kernels; None where no marker ran."""
    walked = phase_walk(kernels)
    if not walked:
        return None
    res = {}
    for name, _ in PHASES:
        if name in walked:
            by_name = walked[name]
            families: Dict[str, float] = {}
            for n, v in by_name.items():
                fam = kernel_family(n)
                families[fam] = families.get(fam, 0.0) + v / 1e3 / reps
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
            res[name] = {"ms": sum(by_name.values()) / 1e3 / reps,
                         "device_ms": dict(sorted(families.items())),
                         "top_kernels_ms": [[n[:120], v / 1e3 / reps]
                                            for n, v in top]}
    return res


def nan_guard(metrics: Dict[str, float], step_info: str = "") -> None:
    """Raise FloatingPointError if any value of ``metrics`` is not finite."""
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad:
        raise FloatingPointError(f"non-finite losses {bad} {step_info}")


@contextlib.contextmanager
def trace(logdir: str, cuda: bool):
    """Profile the enclosed work (host, and the card's kernels where
    ``cuda``) and write it into ``logdir`` as a TensorBoard / Chrome trace
    (``*.pt.trace.json``)."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        if cuda:
            torch.cuda.synchronize()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def kernel_family(name: str) -> str:
    for family, pattern in _OWN:
        if pattern.search(name):
            return family
    low = name.lower()
    if any(k in low for k in LIBRARY_CONV):
        return "library_conv"
    return "other"


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def breakdown(kernels: List[Tuple[str, float, float]], window_us: float,
              reps: int) -> Dict[str, object]:
    """kernels: (name, start_us, end_us) of every device kernel in a window
    of ``window_us`` that ran ``reps`` forwards."""
    if not kernels:
        return {"device_ms": "not measured", "idle_share": "not measured"}
    by_family: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    by_name: Dict[str, float] = {}
    for name, s, e in kernels:
        fam = kernel_family(name)
        by_family[fam] = by_family.get(fam, 0.0) + (e - s)
        launches[fam] = launches.get(fam, 0) + 1
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    busy = busy_us((s, e) for _, s, e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {
        "device_ms": {k: v / 1e3 / reps for k, v in sorted(by_family.items())},
        "launches": {k: v // reps for k, v in sorted(launches.items())},
        "busy_ms": busy / 1e3 / reps,
        "idle_share": max(0.0, 1.0 - busy / window_us),
        "top_kernels_ms": [[n[:120], v / 1e3 / reps] for n, v in top],
    }


def profile_calls(fn, reps: int, warmup: int = 3) -> Dict[str, object]:
    """Host wall ms of one ``fn()`` and its device breakdown over ``reps``
    profiled calls, after ``warmup`` unprofiled ones."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # Device events that are not kernels: user annotations (an optimizer's
    # step shows as a device range over its own kernels).
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    starts = [e.time_range.start for e in events]
    ends = [e.time_range.end for e in events]
    window = (max(ends) - min(starts)) if starts else wall_ms * 1e3
    launched: Dict[str, int] = {}
    copies: Dict[str, int] = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        for names, counts in ((HOST_LAUNCHES, launched),
                              (HOST_COPIES, copies)):
            if e.name in names:
                counts[e.name] = counts.get(e.name, 0) + 1
    res = {"wall_ms": wall_ms / reps,
           "host_launches": {k: v / reps for k, v in sorted(launched.items())},
           "host_copies": {k: v / reps for k, v in sorted(copies.items())}}
    res.update(breakdown(kernels, window, reps))
    phases = phase_breakdown(kernels, reps)
    if phases is not None:
        res["phases"] = phases
    return res


def profile_forward(forward, x, reps: int) -> Dict[str, object]:
    res = {"batch": int(x.shape[0])}
    res.update(profile_calls(lambda: forward(x), reps))
    return res


def profile_u8_eval(forward, src_u8, tgt_u8, reps: int) -> Dict[str, object]:
    """The ``u8_eval`` program on one batch, op by op and through the
    forward's graphed programs (its first call captures)."""
    from tactile_gan_torch.eval.graph import ServingPrograms

    eager = ServingPrograms(forward.gen, forward.device, graphed=False)
    graphed = forward.programs()
    res = {"eager": profile_calls(lambda: eager("u8_eval", src_u8, tgt_u8),
                                  reps),
           "graphed": profile_calls(
               lambda: graphed("u8_eval", src_u8, tgt_u8), reps)}
    (prog,) = [p for key, p in graphed.programs.items()
               if key[1][0] == tuple(src_u8.shape)]
    res["graphed"]["capture_s"] = prog.capture_s
    return res


@dataclasses.dataclass
class FixedStep:
    """A training state and its step on one fixed uint8 batch: ``eager()``
    runs the eager step, ``__call__`` the step as the trainer runs it
    (``graphed``, one CUDA graph a GP variant, on the card; eager on the
    CPU). Each returns the five losses and updates the state."""
    cfg: "TrainConfig"
    state: "TrainState"
    step: "TrainStep"
    rng: "torch.Generator"
    src: "torch.Tensor"
    tgt: "torch.Tensor"
    graphed: "GraphedStep | None"

    def eager(self, apply_gp: bool = True) -> "torch.Tensor":
        return self.step(self.state, self.src, self.tgt, apply_gp=apply_gp,
                         generator=self.rng)

    def __call__(self, apply_gp: bool = True) -> "torch.Tensor":
        if self.graphed is None:
            return self.eager(apply_gp)
        return self.graphed(self.src, self.tgt, apply_gp=apply_gp)


def fixed_step(cfg: "TrainConfig", seed: int, device: str = "cuda"
               ) -> FixedStep:
    """``cfg``'s networks with N(0, 0.02) weights from ``seed`` (D's from
    ``seed + 1``), their Adam pair, the step (the v1 perceptual loss on the
    seeded VGG fallback where ``cfg.lambda_per`` asks for it) and a uint8
    batch drawn from ``seed`` on ``device``; graphed on the card."""
    from tactile_gan_torch.core.device import resolve_device
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import networks
    from tactile_gan_torch.models.vgg import load_vgg_features
    from tactile_gan_torch.train.graph import GraphedStep
    from tactile_gan_torch.train.schedule import multistep_lr
    from tactile_gan_torch.train.state import TrainState, make_optimizer
    from tactile_gan_torch.train.step import build_train_step

    dev = resolve_device(device)
    gen, disc = networks(cfg)
    init_weights(gen, torch.Generator().manual_seed(seed))
    init_weights(disc, torch.Generator().manual_seed(seed + 1))
    gen.to(dev)
    disc.to(dev)
    state = TrainState(gen, disc,
                       make_optimizer(gen.parameters(), cfg.lr, cfg.beta1),
                       make_optimizer(disc.parameters(), cfg.lr, cfg.beta1))
    vgg = (load_vgg_features(cfg.vgg_weights, device=dev)
           if cfg.lambda_per != 0 and cfg.version == 1 else None)
    step = build_train_step(cfg, multistep_lr(cfg.lr, cfg.epoch_constant,
                                              cfg.total_epochs, 100), vgg)
    rng = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.batch_size, cfg.image_size, cfg.image_size, 3)
    src, tgt = (torch.randint(0, 256, shape, generator=rng, device=dev,
                              dtype=torch.uint8) for _ in range(2))
    graphed = (GraphedStep(step, state, rng) if dev.type == "cuda"
               else None)
    return FixedStep(cfg, state, step, rng, src, tgt, graphed)


def profile_train(reps: int, seed: int, gen_name: str = "UNet++"
                  ) -> Dict[str, object]:
    """One steady-state training step at the train.py defaults (with the
    ``gen_name`` generator), graphed as the trainer runs it and eager, on
    one state."""
    from tactile_gan_torch.core.config import TrainConfig

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    fs = fixed_step(TrainConfig(gen=gen_name), seed, dev)
    cfg = fs.cfg
    res = {"gen": cfg.gen, "batch": cfg.batch_size,
           "image_size": cfg.image_size, "nf": cfg.nf}
    res["graphed"] = profile_calls(lambda: fs(apply_gp=True), reps, warmup=2)
    res["graphed"]["capture_s"] = fs.graphed.captured[True].capture_s
    # Peak device memory up to the graphed step's profile (state, graph
    # pool and one eager step).
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    res["eager"] = profile_calls(lambda: fs.eager(apply_gp=True), reps,
                                 warmup=2)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gen", default="UNet++",
                    choices=["UNet++", "UNet", "BCDUNet", "SPADE"])
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of forwards")
    ap.add_argument("--out", default=None,
                    help="JSON path (default perf_out/profile_forward.json "
                         "or perf_out/profile_train.json)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(
        "perf_out", "profile_train.json" if args.train else
        "profile_forward.json")

    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.core.device import resolve_device
    from tactile_gan_torch.eval.runner import GeneratorForward
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import create_generator

    dev = resolve_device("cuda")
    results = []
    if args.train:
        results.append(profile_train(args.reps, args.seed, args.gen))
        print(json.dumps(results[-1]), flush=True)
    else:
        cfg = TrainConfig(gen=args.gen)
        gen = create_generator(cfg.gen, nf=cfg.nf,
                               compute_dtype=cfg.torch_compute_dtype)
        init_weights(gen, torch.Generator().manual_seed(args.seed))
        forward = GeneratorForward(gen.to(dev).eval(), dev)
        rng = torch.Generator(device=dev).manual_seed(args.seed)
        for b in args.batch:
            x = torch.rand((b, cfg.image_size, cfg.image_size, 3), device=dev,
                           generator=rng) * 2 - 1
            res = {"gen": cfg.gen, **profile_forward(forward, x, args.reps)}
            src, tgt = (torch.randint(0, 256, x.shape, generator=rng,
                                      device=dev, dtype=torch.uint8)
                        for _ in range(2))
            res["u8_eval"] = profile_u8_eval(forward, src, tgt, args.reps)
            results.append(res)
            print(json.dumps(res), flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    card = card_line()
    print(card)
    with open(out, "w") as f:
        json.dump({"card": card, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
