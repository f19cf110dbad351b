#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (tactile_gan_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--images 126]

Phases, each raising on failure:
  0. build the hand-written kernels from tactile_gan_torch/csrc (one nvcc
     per source, in parallel) and print ptxas's register/spill report;
  1. hold each kernel against its plain PyTorch version on the card, at
     a few shapes off the serving path (partial tiles, odd channel counts)
     and at every shape the serving forward gives it, in float32 and
     bfloat16;
  2. time each kernel, its plain version and one library call computing the
     same function (a yardstick only: the port never calls it), beside the
     least time the card could take (bytes / 3.35 TB/s or flops / peak);
  3. serve: a UNet++ nf=64 generator at 256x256 with N(0, 0.02) weights from
     --seed is written as models/<folder>/final_model.pth + params.txt under
     a temporary work root, loaded through the port's load_model on cuda,
     timed alone at batch 1 and 4, then run through evaluate_folder (the
     test.py flow) over synthetic chart pairs written as PNG/TIFF files, at
     eval_batch 1 and 4 (the plots are skipped where matplotlib is not
     installed; the runner says so). The launch counts
     must show both kernels on the path; the outputs must be finite; the
     card's output for one image must match the same weights run on the CPU
     through the plain path.

Prints the card (nvidia-smi name and power limit), one JSON line of kernel
numbers, and last {"ok": true, "device": {...}}. Details go to --out
(perf_out/chip_smoke.json). Exits non-zero without a result when no CUDA
device is available or the package is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# bf16 outputs: one rounding of the result on each side; a flipped rounding
# is one bf16 ulp (<= 2^-7 of the value), 2^-6 covers the neighbouring
# binade. float32 outputs: float32 sums taken in another order (kernel A:
# statistics over up to 65,536 pixels; kernel B: up to 3,456 products).
TOL = {"bfloat16": (1e-2, 2.0 ** -6), "float32": (1e-4, 1e-4)}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor cores
              "float32": 67e12}    # CUDA cores
# Whole-network agreement of the card with the CPU plain path, tanh outputs.
# float32 compute: both in float32 (TF32 off), sums in another order.
# bfloat16 compute: bf16 roundings of the library convs differ between cuDNN
# and the CPU library; the port's bf16 error against float32 is ~0.05 max.
SERVE_TOL = {"float32": (2e-3, 1e-4), "bfloat16": (0.1, 1e-2)}  # max, mean

# (shape (H, W, C), launches per forward) of kernel A on the serving path.
A_SHAPES = [((256, 256, 64), 10), ((128, 128, 128), 8), ((64, 64, 256), 6),
            ((32, 32, 512), 4), ((16, 16, 1024), 2)]
# (Cin, launches per forward) of kernel B: conv0_0's second conv and the
# four conv0_c second convs (Cin 64), the conv0_c first convs (c = 1..4).
B_CINS = [(64, 5), (192, 1), (256, 1), (320, 1), (384, 1)]
FULL_RES = 256
A_PER_FORWARD = sum(k for _, k in A_SHAPES)
B_PER_FORWARD = sum(k for _, k in B_CINS)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, target_ms: float = 10.0):
    """(device ms, call ms) of one call of fn.

    The call time is host wall clock over a synchronised run of calls: the
    larger of the host's launch work and the device's. For the device time
    the calls are queued behind a device-side sleep that outlasts their
    launching, so the events around them time the device running them back
    to back rather than the Python that launches them."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = max((time.perf_counter() - t0) * 1e3, 1e-3)
    iters = int(min(50, max(5, target_ms / est)))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2x the measured launch time, at 2e6 cycles a ms (the SM clock is at
    # most 1.98 GHz, so a slower clock only sleeps longer).
    torch.cuda._sleep(int(2 * call_ms * iters * 2e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, call_ms


def check_close(name, got, want, dtype_name):
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    worst = (err - (atol + rtol * w.abs())).max().item()
    max_err = err.max().item()
    if not (math.isfinite(max_err) and worst <= 0):
        raise AssertionError(f"{name}: kernel and plain version disagree, "
                             f"max |diff| {max_err:.3e} (atol {atol}, "
                             f"rtol {rtol})")
    return max_err


# Shapes off the serving path, for the kernels' edges: partial tiles, C and
# Cin not a multiple of 16, Co below 64, every activation, no affine.
EDGE_A = [((3, 7, 5, 24), "leaky_relu", True), ((2, 9, 13, 136), None, False),
          ((1, 1, 1, 8), "relu", True)]
EDGE_B = [((2, 37, 53, 24), 32), ((1, 9, 17, 8), 16), ((1, 40, 70, 40), 64)]


def phase_edges(torch, ka, kb, seed):
    """Kernel vs plain version at shapes off the serving path."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    for shape, act, affine in EDGE_A:
        c = shape[-1]
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[1]
            x = (torch.randn(shape, device="cuda", generator=gen) + 1).to(dt)
            s = o = None
            if affine:
                s = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
                o = 0.1 * torch.randn(c, device="cuda", generator=gen)
            y = ka.instance_norm_act(x, s, o, act=act)
            torch.cuda.synchronize()
            err = check_close(f"A edge {shape} {dn} {act}", y,
                              ka.instance_norm_act_plain(x, s, o, act=act), dn)
            print(f"A edge {list(shape)} {dn} act={act} affine={affine}: "
                  f"max|diff| {err:.3e}", flush=True)
    for shape, co in EDGE_B:
        for in_dt, cd in ((torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.bfloat16),
                          (torch.float32, torch.float32),
                          (torch.bfloat16, torch.float32)):
            dn, cn = str(in_dt).split(".")[1], str(cd).split(".")[1]
            x = torch.randn(shape, device="cuda", generator=gen).to(in_dt)
            wt = 0.1 * torch.randn((co, shape[-1], 3, 3), device="cuda",
                                   generator=gen)
            y = kb.conv3x3(x, wt, compute_dtype=cd)
            torch.cuda.synchronize()
            err = check_close(f"B edge {shape} co {co} {dn}/{cn}", y,
                              kb.conv3x3_plain(x, wt, compute_dtype=cd), dn)
            print(f"B edge {list(shape)} co={co} {dn}/{cn}: max|diff| "
                  f"{err:.3e}", flush=True)


def phase_kernels(torch, ka, kb, seed, record):
    """Kernel vs plain version at every serving shape; then times."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    a_rows, b_rows = [], []
    for batch in (1, 4):
        for (h, w, c), per_fwd in A_SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                dn = str(dt).split(".")[1]
                x = (torch.randn((batch, h, w, c), device=dev, generator=gen)
                     * 2 + 0.5).to(dt)
                s = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
                o = 0.1 * torch.randn(c, device=dev, generator=gen)
                y = ka.instance_norm_act(x, s, o, act="relu")
                torch.cuda.synchronize()
                ref = ka.instance_norm_act_plain(x, s, o, act="relu")
                err = check_close(f"A {x.shape} {dn}", y, ref, dn)
                nbytes = 2 * x.numel() * x.element_size()
                row = {"shape": [batch, h, w, c], "dtype": dn,
                       "per_forward": per_fwd, "max_abs_err": err,
                       "tol": TOL[dn],
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "bound_by": "bytes"}
                row["ms"], row["call_ms"] = cuda_ms(
                    lambda: ka.instance_norm_act(x, s, o, act="relu"))
                row["plain_ms"], _ = cuda_ms(
                    lambda: ka.instance_norm_act_plain(x, s, o, act="relu"))
                xl = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
                row["library_ms"], _ = cuda_ms(lambda: torch.relu(
                    torch.nn.functional.instance_norm(xl, weight=s, bias=o,
                                                      eps=ka.EPS)))
                a_rows.append(row)
                print(f"A {row['shape']} {dn}: max|diff| {err:.3e} "
                      f"(atol {TOL[dn][0]}, rtol {TOL[dn][1]:.4g}) "
                      f"ms {row['ms']:.4f} (call {row['call_ms']:.4f}) plain "
                      f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} "
                      f"bound {row['bound_ms']:.4f}", flush=True)
        # Kernel B: (input dtype, compute dtype); the serving path runs the
        # first (float32 activations, bf16 operands).
        combos = [(torch.float32, torch.bfloat16)]
        if batch == 1:
            combos += [(torch.bfloat16, torch.bfloat16),
                       (torch.float32, torch.float32)]
        for cin, per_fwd in B_CINS:
            for in_dt, cd in combos:
                dn, cn = str(in_dt).split(".")[1], str(cd).split(".")[1]
                x = torch.randn((batch, FULL_RES, FULL_RES, cin), device=dev,
                                generator=gen).to(in_dt)
                wt = 0.05 * torch.randn((64, cin, 3, 3), device=dev,
                                        generator=gen)
                y = kb.conv3x3(x, wt, compute_dtype=cd)
                torch.cuda.synchronize()
                ref = kb.conv3x3_plain(x, wt, compute_dtype=cd)
                err = check_close(f"B {x.shape} {dn}/{cn}", y, ref, dn)
                flops = 2 * x.numel() // cin * 9 * cin * 64
                nbytes = (x.numel() + x.numel() // cin * 64) * x.element_size() \
                    + 9 * cin * 64 * (2 if cd == torch.bfloat16 else 4)
                t_ops = flops / PEAK_FLOPS[cn] * 1e3
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                row = {"shape": [batch, FULL_RES, FULL_RES, cin], "co": 64,
                       "dtype": dn, "compute": cn, "per_forward": per_fwd,
                       "max_abs_err": err, "tol": TOL[dn], "flops": flops,
                       "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
                row["ms"], row["call_ms"] = cuda_ms(
                    lambda: kb.conv3x3(x, wt, compute_dtype=cd))
                row["plain_ms"], _ = cuda_ms(lambda: kb.conv3x3_plain(
                    x, wt, compute_dtype=cd))
                xl = x.to(cd).permute(0, 3, 1, 2)
                wl = wt.to(cd)
                row["library_ms"], _ = cuda_ms(
                    lambda: torch.nn.functional.conv2d(xl, wl, padding=1))
                row["tflops"] = flops / row["ms"] / 1e9
                b_rows.append(row)
                print(f"B {row['shape']} {dn}/{cn}: max|diff| {err:.3e} "
                      f"(atol {TOL[dn][0]}, rtol {TOL[dn][1]:.4g}) "
                      f"ms {row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s, call "
                      f"{row['call_ms']:.4f}) plain {row['plain_ms']:.4f} library "
                      f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f}",
                      flush=True)
    record["kernel_a"] = a_rows
    record["kernel_b"] = b_rows
    return a_rows, b_rows


def per_forward(rows, key, pick):
    """Sum of `key` over one serving forward's launches (rows picked)."""
    return sum(r[key] * r["per_forward"] for r in rows if pick(r))


def serving_rows(batch):
    """Picks the rows of the serving path's dtypes: float32 activations and,
    for kernel B, bf16 operands."""
    return lambda r: (r["shape"][0] == batch and r["dtype"] == "float32"
                      and r.get("compute", "bfloat16") == "bfloat16")


def chart_pairs(n, size, seed):
    """Synthetic chart-like pairs: a white page with black axes, coloured
    bars and a polyline (source), and the same strokes in black (target)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        src = np.full((size, size, 3), 255, np.uint8)
        tac = np.full((size, size, 3), 255, np.uint8)
        base, left = size - 20, 20
        for img in (src, tac):
            img[base:base + 2, left:size - 10] = 0
            img[10:base + 2, left:left + 2] = 0
        n_bars = int(rng.integers(3, 9))
        width = (size - left - 20) // (2 * n_bars)
        for j in range(n_bars):
            x0 = left + 8 + 2 * j * width
            top = int(rng.integers(20, base - 10))
            colour = rng.integers(0, 220, 3).astype(np.uint8)
            src[top:base, x0:x0 + width] = colour
            tac[top:base, x0:x0 + width] = 0
        ys = rng.integers(15, base - 5, 6)
        xs = np.linspace(left + 4, size - 12, 6).astype(int)
        for (x0, y0), (x1, y1) in zip(zip(xs, ys), zip(xs[1:], ys[1:])):
            for t in np.linspace(0.0, 1.0, 4 * (x1 - x0)):
                yy, xx = int(y0 + t * (y1 - y0)), int(x0 + t * (x1 - x0))
                src[yy:yy + 2, xx:xx + 2] = (200, 30, 30)
                tac[yy:yy + 2, xx:xx + 2] = 0
        pairs.append((src, tac))
    return pairs


def phase_serve(torch, ka, kb, args, record):
    from PIL import Image  # the runner decodes and writes with it

    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.eval import runner
    from tactile_gan_torch.eval.visualize import can_plot
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import create_generator
    from tactile_gan_torch.utils.checkpoint import save_checkpoint

    flow = "evaluate_folder, plots " + (
        "drawn" if can_plot() else "skipped (matplotlib is not installed)")
    print(f"serving flow: {flow}", flush=True)
    pairs = chart_pairs(args.images, FULL_RES, args.seed)
    out = {"flow": flow, "images": args.images, "forward": [], "runs": []}
    with tempfile.TemporaryDirectory() as root:
        cfg = TrainConfig(data="data", folder_save="smoke",
                          folder_load="smoke", threads=8)
        model_dir = os.path.join(root, "models", "smoke")
        os.makedirs(model_dir)
        cfg.save_params(model_dir)
        gen = create_generator(cfg.gen, nf=cfg.nf)
        init_weights(gen, torch.Generator().manual_seed(args.seed))
        ckpt = os.path.join(model_dir, "final_model.pth")
        save_checkpoint(ckpt, gen=gen.state_dict())
        for k in ("gen", "disc", "l1", "gp", "per"):
            np.save(os.path.join(model_dir, f"{k}loss.npy"),
                    np.linspace(1.0, 0.2, 10).astype(np.float32))
        src_dir = os.path.join(root, "data", "test", "source")
        tac_dir = os.path.join(root, "data", "test", "tactile")
        os.makedirs(src_dir)
        os.makedirs(tac_dir)
        for i, (s, t) in enumerate(pairs):
            Image.fromarray(s).save(os.path.join(src_dir, f"s_{i:04d}.png"))
            Image.fromarray(t).save(os.path.join(tac_dir, f"t_{i:04d}.tiff"))

        # The generator alone, through the port's load_model: the first
        # calls warm cuDNN's algorithm choice and the allocator.
        t0 = time.perf_counter()
        forward, _ = runner.load_model(ckpt, cfg, device="cuda")
        torch.cuda.synchronize()
        out["load_model_s"] = time.perf_counter() - t0
        print(f"load_model: {out['load_model_s']:.3f} s", flush=True)
        for b in (1, 4):
            x = runner.normalize_u8(torch.from_numpy(
                np.stack([p[0] for p in pairs[:b]])).cuda())
            for _ in range(3):
                y = forward(x)
            torch.cuda.synchronize()
            if y.shape != (b, FULL_RES, FULL_RES, 3) or y.dtype != torch.float32:
                raise AssertionError(f"generator output {y.dtype} {tuple(y.shape)}")
            if not torch.isfinite(y).all() or y.abs().max() > 1:
                raise AssertionError("generator output is not finite tanh")
            reps = 10
            t0 = time.perf_counter()
            for _ in range(reps):
                forward(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / reps
            out["forward"].append({"batch": b, "ms": ms,
                                   "img_per_s": b * 1e3 / ms})
            print(f"generator forward, batch {b}: {ms:.3f} ms = "
                  f"{b * 1e3 / ms:.2f} img/s", flush=True)

        for eval_batch in (1, 4):
            ka.instance_norm_act.launches = 0
            kb.conv3x3.launches = 0
            t0 = time.perf_counter()
            metrics = runner.evaluate_folder(
                "smoke", work_root=root, eval_batch=eval_batch, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_a, n_b = ka.instance_norm_act.launches, kb.conv3x3.launches
            forwards = -(-args.images // eval_batch)
            run = {"eval_batch": eval_batch, "seconds": wall,
                   "img_per_s": args.images / wall, "forwards": forwards,
                   "launches_a": n_a, "launches_b": n_b, "metrics": metrics}
            out["runs"].append(run)
            print(f"serve eval_batch {eval_batch}: {args.images} images in "
                  f"{wall:.3f} s = {run['img_per_s']:.2f} img/s; launches "
                  f"A {n_a} B {n_b} over {forwards} forwards; {metrics}",
                  flush=True)
            if (n_a, n_b) != (A_PER_FORWARD * forwards, B_PER_FORWARD * forwards):
                raise AssertionError(
                    f"expected {A_PER_FORWARD} A and {B_PER_FORWARD} B launches "
                    f"per forward, got A {n_a} B {n_b} over {forwards}")
            if not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"non-finite metrics {metrics}")
            out_dir = os.path.join(root, "Outputs", "smoke")
            written = sorted(os.listdir(os.path.join(out_dir, "out")))
            if len(written) != args.images or not os.path.exists(
                    os.path.join(out_dir, "eval.txt")):
                raise AssertionError(f"artifacts missing: {written}")

        # The card against the CPU plain path, same weights, one image.
        x = torch.from_numpy(pairs[0][0][None])
        for cd in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, compute_dtype=cd)
            f_gpu, _ = runner.load_model(ckpt, c, device="cuda")
            f_cpu, _ = runner.load_model(ckpt, c, device="cpu")
            got = f_gpu(runner.normalize_u8(x.cuda())).cpu()
            t0 = time.perf_counter()
            want = f_cpu(runner.normalize_u8(x))
            cpu_s = time.perf_counter() - t0
            d = (got - want).abs()
            max_tol, mean_tol = SERVE_TOL[cd]
            res = {"compute": cd, "max_abs": d.max().item(),
                   "mean_abs": d.mean().item(), "max_tol": max_tol,
                   "mean_tol": mean_tol, "cpu_forward_s": cpu_s}
            out.setdefault("card_vs_cpu", []).append(res)
            print(f"card vs CPU plain path ({cd}): max|diff| "
                  f"{res['max_abs']:.3e} (tol {max_tol}), mean "
                  f"{res['mean_abs']:.3e} (tol {mean_tol})", flush=True)
            if not (res["max_abs"] <= max_tol and res["mean_abs"] <= mean_tol):
                raise AssertionError(f"card and CPU disagree: {res}")
    record["serve"] = out
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--images", type=int, default=126,
                    help="synthetic test pairs (126 leaves a padded tail at "
                         "eval_batch 4)")
    ap.add_argument("--out", default=os.path.join("perf_out",
                                                  "chip_smoke.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from tactile_gan_torch.ops.kernels import build
    from tactile_gan_torch.ops.kernels import conv3x3 as kb
    from tactile_gan_torch.ops.kernels import instance_norm as ka

    # f32 results are compared: no TF32 in the library convs or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed}
    t0 = time.perf_counter()
    build.build_all(["instance_norm_act", "conv3x3"])
    record["build_s"] = time.perf_counter() - t0
    print(f"built kernels in {record['build_s']:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    phase_edges(torch, ka, kb, args.seed)
    a_rows, b_rows = phase_kernels(torch, ka, kb, args.seed, record)
    serve = phase_serve(torch, ka, kb, args, record)

    launches = {k: sum(run[k] for run in serve["runs"])
                for k in ("launches_a", "launches_b")}
    kernels = []
    pick = serving_rows(1)
    for name, rows, route_src, replaces, key in (
            ("instance_norm_act", a_rows,
             "tactile_gan_torch/csrc/instance_norm_act.cu",
             "tactile_gan_tpu/ops/pallas/instance_norm.py:492", "launches_a"),
            ("conv3x3", b_rows, "tactile_gan_torch/csrc/conv3x3.cu",
             "tactile_gan_tpu/ops/pallas/conv3x3.py:394", "launches_b")):
        kernels.append({
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(r["max_abs_err"] for r in rows if pick(r)),
            "ms": per_forward(rows, "ms", pick),
            "plain_ms": per_forward(rows, "plain_ms", pick),
            "bound_ms": per_forward(rows, "bound_ms", pick),
            "bound_by": rows[[pick(r) for r in rows].index(True)]["bound_by"],
            "library_ms": per_forward(rows, "library_ms", pick),
            "per": "one batch-1 serving forward (all its launches), float32 "
                   "activations" + (", bf16 operands" if name == "conv3x3" else ""),
            "card": card})
    record["kernels"] = kernels
    record["per_forward"] = {
        name: {f"batch{b}": {k: per_forward(rows, k, serving_rows(b))
                             for k in ("ms", "plain_ms", "bound_ms",
                                       "library_ms")} for b in (1, 4)}
        for name, rows in (("instance_norm_act", a_rows), ("conv3x3", b_rows))}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
