"""Conv probe: kernel E against the library conv at the row-0 shapes.

    python -m tactile_gan_torch.cli.probe_conv [B S] [--device cuda|cpu]

The port of ``scripts/probe_pallas_conv.py``. For each (Cin, Co) of (64, 64),
(32, 64) and (64, 32) it draws x (B, S, S, Cin) and an HWIO weight (times
0.05) from numpy's ``default_rng(0)`` as that script does (defaults B 4,
S 256), prints kernel E's relative error against the library conv (max
|E - library| / max |library|), then the ms and TFLOP/s (useful flops
2 * 9 * Cin * Co * B * S^2 over the time) of each formulation:

  library      ``F.conv2d`` on bfloat16 channels-last operands, the
               counterpart of the script's ``conv_plain``;
  E p1         kernel E through ``conv3x3_p1`` (the Pallas W-pair kernel's
               port);
  E p1_h       kernel E through ``conv3x3_p1_h`` (the H-pair kernel's port);
  B            kernel B through ``conv3x3`` on the same weight in OIHW, the
               row-0 production kernel, which computes the same function.

E and B round x and the weight to bfloat16 and return float32 sums. The
script's "xla packed" line is dropped: the ``lane_pack`` rewrite is a TPU
layout device that the port does not carry as a code path.

On cuda (the default; it raises without a card) the card's name and power
limit come first, and each time is CUDA events around a run of calls queued
behind a device-side sleep, after a warm-up, with no host sync inside the
run. ``--device cpu`` runs every formulation's plain PyTorch version and
times it on the host clock (a check of the flow, not a device number).
``main`` returns the numbers, with the calls it made through each kernel
wrapper, as a dict.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator, Tuple

import numpy as np

SHAPES = ((64, 64), (32, 64), (64, 32))  # (Cin, Co)
WARMUP = 3
ITERS = {"cuda": 20, "cpu": 1}
# (printed label, the call timed): the library conv, then the kernel
# wrappers, whose calls the probe counts.
FORMULATIONS = (("library", "library"), ("E p1", "conv3x3_p1"),
                ("E p1_h", "conv3x3_p1_h"), ("B", "conv3x3"))


def inputs(batch: int, size: int
           ) -> Iterator[Tuple[int, int, np.ndarray, np.ndarray]]:
    """(Cin, Co, x, k) for each probe shape, in order, from one
    ``default_rng(0)``: x (B, S, S, Cin) and k (3, 3, Cin, Co) float32."""
    rng = np.random.default_rng(0)
    for cin, co in SHAPES:
        x = rng.normal(size=(batch, size, size, cin)).astype(np.float32)
        k = rng.normal(size=(3, 3, cin, co)).astype(np.float32) * 0.05
        yield cin, co, x, k


def _time_ms(torch, fn, dev) -> float:
    """ms of one call of fn: CUDA events on the card, host clock on cpu."""
    iters = ITERS[dev.type]
    for _ in range(WARMUP):
        fn()
    if dev.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    launch_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Twice the host's launch time at 2e6 cycles a ms (the SM clock is at
    # most 1.98 GHz), so the events time the device running the calls back
    # to back rather than Python launching them.
    torch.cuda._sleep(int(2 * launch_ms * 2e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", nargs="*", type=int, metavar="B S",
                    help="batch and image size (default 4 256)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if len(args.shape) not in (0, 2):
        ap.error("give both B and S, or neither")
    batch, size = args.shape or (4, 256)

    import torch
    import torch.nn.functional as F

    from tactile_gan_torch.core.device import resolve_device
    from tactile_gan_torch.ops.kernels import conv3x3 as kb
    from tactile_gan_torch.utils.profiling import card_line

    dev = resolve_device(args.device)
    print(f"backend: {dev.type}", flush=True)
    card = card_line() if dev.type == "cuda" else None
    if card:
        print(card, flush=True)
    calls = {name: 0 for _, name in FORMULATIONS[1:]}
    rows = []
    with torch.no_grad():
        for cin, co, xn, kn in inputs(batch, size):
            x = torch.from_numpy(xn).to(dev)
            k = torch.from_numpy(kn).to(dev)
            w = kb.hwio_to_oihw(k).contiguous()
            xl = x.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last
            wl = w.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            fns = {"library": lambda: F.conv2d(xl, wl, padding=1),
                   "conv3x3_p1": lambda: kb.conv3x3_p1(x, k),
                   "conv3x3_p1_h": lambda: kb.conv3x3_p1_h(x, k),
                   "conv3x3": lambda: kb.conv3x3(x, w)}

            def call(name):
                if name in calls:
                    calls[name] += 1
                return fns[name]()

            gflop = 2 * 9 * cin * co * batch * size * size / 1e9
            want = call("library").float().permute(0, 2, 3, 1)
            got = call("conv3x3_p1")
            rel = ((got - want).abs().max() / want.abs().max()).item()
            print(f"cin={cin} co={co} (B{batch} {size}^2): kernel E rel err "
                  f"{rel:.2e}", flush=True)
            row = {"cin": cin, "co": co, "gflop": gflop, "rel_err": rel,
                   "ms": {}, "tflops": {}}
            for label, name in FORMULATIONS:
                ms = _time_ms(torch, lambda: call(name), dev)
                row["ms"][label] = ms
                row["tflops"][label] = gflop / ms
                print(f"  {label:<7}: {ms:7.3f} ms  {gflop / ms:7.1f} TFLOP/s",
                      flush=True)
            rows.append(row)
    return {"device": dev.type, "card": card, "batch": batch, "size": size,
            "clock": "CUDA events" if dev.type == "cuda" else "host",
            "shapes": rows, "calls": calls}


if __name__ == "__main__":
    main()
