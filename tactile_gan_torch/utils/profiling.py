"""Where the device time of a serving forward or a training step goes.

    python -m tactile_gan_torch.utils.profiling [--gen G] [--batch 1 4] [--reps 5]
    python -m tactile_gan_torch.utils.profiling --train [--gen G] [--reps 3]

Builds the ``--gen`` generator (UNet++, UNet or BCDUNet; UNet++ by default)
at nf=64 and 256x256 with N(0, 0.02) weights from ``--seed`` and the
default bfloat16 compute. The default mode runs
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
memory up to the graphed profile. Needs a CUDA device; the JSON
goes to ``--out``. A profile that records no device kernel reports the
device times as not measured instead of zeros.

The trainer's hooks live here too: ``trace`` (``--profile_dir``, a
``torch.profiler`` trace of the first epoch), ``nan_guard``
(``--debug_nans``, a check of each step's losses) and ``StepTimer``, the
port of ``tactile_gan_tpu/utils/profiling.py``'s three.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import time
from typing import Dict, Iterable, List, Tuple

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


class StepTimer:
    """Host time of each step, with p50/p90: ``start()``, then
    ``stop(block_on=t)``, which first waits for the device of tensor ``t``
    (nothing to wait for on the CPU)."""

    def __init__(self):
        self.durations: List[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, block_on=None) -> None:
        if block_on is not None and block_on.is_cuda:
            import torch

            torch.cuda.synchronize(block_on.device)
        self.durations.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        import numpy as np

        d = np.asarray(self.durations)
        return {"steps": int(d.size), "mean_s": float(d.mean()),
                "p50_s": float(np.percentile(d, 50)),
                "p90_s": float(np.percentile(d, 90))}


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
    import torch
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
    import torch
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


def profile_train(reps: int, seed: int, gen_name: str = "UNet++"
                  ) -> Dict[str, object]:
    """One steady-state training step at the train.py defaults (with the
    ``gen_name`` generator), graphed as the trainer runs it and eager, on
    one state."""
    import torch

    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import (
        create_discriminator, create_generator,
    )
    from tactile_gan_torch.models.vgg import load_vgg_features
    from tactile_gan_torch.train.graph import GraphedStep
    from tactile_gan_torch.train.schedule import multistep_lr
    from tactile_gan_torch.train.state import TrainState, make_optimizer
    from tactile_gan_torch.train.step import build_train_step

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = TrainConfig(gen=gen_name)
    cd = cfg.torch_compute_dtype
    gen = create_generator(cfg.gen, nf=cfg.nf, compute_dtype=cd)
    disc = create_discriminator("patch", nf=cfg.nf, compute_dtype=cd)
    init_weights(gen, torch.Generator().manual_seed(seed))
    init_weights(disc, torch.Generator().manual_seed(seed + 1))
    gen.to(dev)
    disc.to(dev)
    state = TrainState(gen, disc,
                       make_optimizer(gen.parameters(), cfg.lr, cfg.beta1),
                       make_optimizer(disc.parameters(), cfg.lr, cfg.beta1))
    step = build_train_step(cfg, multistep_lr(cfg.lr, cfg.epoch_constant,
                                              cfg.total_epochs, 100),
                            load_vgg_features(device=dev))
    rng = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.batch_size, cfg.image_size, cfg.image_size, 3)
    src = torch.randint(0, 256, shape, generator=rng, device=dev,
                        dtype=torch.uint8)
    tgt = torch.randint(0, 256, shape, generator=rng, device=dev,
                        dtype=torch.uint8)
    graphed = GraphedStep(step, state, rng)
    res = {"gen": cfg.gen, "batch": cfg.batch_size,
           "image_size": cfg.image_size, "nf": cfg.nf}
    res["graphed"] = profile_calls(
        lambda: graphed(src, tgt, apply_gp=True), reps, warmup=2)
    res["graphed"]["capture_s"] = graphed.captured[True].capture_s
    # Peak device memory up to the graphed step's profile (state, graph
    # pool and one eager step).
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    res["eager"] = profile_calls(
        lambda: step(state, src, tgt, apply_gp=True, generator=rng), reps,
        warmup=2)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gen", default="UNet++",
                    choices=["UNet++", "UNet", "BCDUNet"])
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of forwards")
    ap.add_argument("--out", default=None,
                    help="JSON path (default perf_out/profile_forward.json "
                         "or perf_out/profile_train.json)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(
        "perf_out", "profile_train.json" if args.train else
        "profile_forward.json")

    import torch

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
