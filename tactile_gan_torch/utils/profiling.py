"""Where the device time of a serving forward goes.

    python -m tactile_gan_torch.utils.profiling [--batch 1 4] [--reps 5]

Builds the UNet++ nf=64 generator at 256x256 with N(0, 0.02) weights from
``--seed`` and the default bfloat16 compute, runs ``--reps`` forwards per
batch size under ``torch.profiler``, and prints per batch: the host wall
time of one forward, the device time of one forward summed by kernel
family (kernel A, kernel B, library convs, everything else) and for the
kernels that took the most, and the share of the profiled window in which
no kernel ran. Needs a CUDA device; the
JSON goes to ``--out``. A profile that records no device kernel reports
the device times as not measured instead of zeros.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, Iterable, List, Tuple

TOP_KERNELS = 12  # kernel names listed by device time

# Substrings of kernel names, checked in order.
FAMILIES = (
    ("kernel_a", ("stats_kernel", "finalize_kernel", "apply_kernel")),
    ("kernel_b", ("conv3x3_bf16_kernel", "conv3x3_f32_kernel")),
    ("library_conv", ("conv", "xmma", "cudnn", "cutlass", "gemm", "sm90_",
                      "sm80_")),
)


def kernel_family(name: str) -> str:
    low = name.lower()
    for family, keys in FAMILIES:
        if any(k in low for k in keys):
            return family
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


def profile_forward(forward, x, reps: int) -> Dict[str, object]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        forward(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            forward(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    starts = [e.time_range.start for e in events]
    ends = [e.time_range.end for e in events]
    window = (max(ends) - min(starts)) if starts else wall_ms * 1e3
    res = {"batch": int(x.shape[0]), "forward_wall_ms": wall_ms / reps}
    res.update(breakdown(kernels, window, reps))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("perf_out",
                                                  "profile_forward.json"))
    args = ap.parse_args(argv)

    import torch

    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.core.device import resolve_device
    from tactile_gan_torch.eval.runner import GeneratorForward
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import create_generator

    dev = resolve_device("cuda")
    cfg = TrainConfig()
    gen = create_generator(cfg.gen, nf=cfg.nf,
                           compute_dtype=cfg.torch_compute_dtype)
    init_weights(gen, torch.Generator().manual_seed(args.seed))
    forward = GeneratorForward(gen.to(dev).eval(), dev)
    rng = torch.Generator(device=dev).manual_seed(args.seed)
    results = []
    for b in args.batch:
        x = torch.rand((b, cfg.image_size, cfg.image_size, 3), device=dev,
                       generator=rng) * 2 - 1
        res = profile_forward(forward, x, args.reps)
        results.append(res)
        print(json.dumps(res), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
