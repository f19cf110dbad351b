#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (tactile_gan_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--images 126]

Phases, each raising on failure (each prints its seconds):
  0. build the hand-written kernels from tactile_gan_torch/csrc (one nvcc
     per source, in parallel) and print ptxas's register/spill report;
  1. hold each kernel against its plain PyTorch version on the card at
     shapes off the main path (partial tiles, channel counts that are not a
     multiple of 64, several output-channel tiles), in float32 and bfloat16:
     A and B forward, C (instance-norm backward), B-dx and D (the conv's
     input and weight gradients);
  2. the same at every shape the serving forward and the training step give
     each kernel, with times: the kernel, its plain version and one library
     call computing the same function (a yardstick only: the port never
     calls it), beside the least time the card could take (bytes /
     3.35 TB/s or flops / peak);
  3. train: synthetic chart pairs are written as data/train under a
     temporary work root and ``tactile_gan_torch.cli.train.main`` runs at
     its defaults (UNet++ nf=64, batch 4, 256x256, ls loss with label
     smoothing, v1 perceptual loss on the port's seeded VGG fallback, GP
     every epoch) for two epochs on cuda. The launch counters must show
     exactly 30 A, 30 C, 9 B, 9 B-dx and 9 D launches a step; the losses
     must be finite and every artifact written. Steady-state ms per step
     and img/s (epoch 2, the host pipeline included) and peak device memory
     are printed. The trained folder is then served through evaluate_folder
     (train -> test end to end);
  4. serve: a UNet++ nf=64 generator with N(0, 0.02) weights from --seed is
     loaded through the port's load_model on cuda, timed alone at batch 1
     and 4, then run through evaluate_folder (the test.py flow) over
     synthetic chart pairs at eval_batch 1 and 4 (the plots are skipped
     where matplotlib is not installed; the runner says so), with the
     launch counts of both forward kernels; the card's output for one image
     must match the same weights run on the CPU through the plain path;
  5. one training step on the card against the same step on the CPU (plain
     versions), from the same weights and injected draws, at nf=16, 64x64,
     batch 2, float32 compute with TF32 off, learning rate 0: the losses
     and every gradient before the Adam update must agree within limits
     (median tensor, worst tensor of the full-resolution row, worst tensor)
     that the same phase shows to lie between the step's float32 floor
     (the CPU step with perturbed weights) and three faults planted in the
     kernels.

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
TRAIN_BATCH = 4
TRAIN_PAIRS = 48  # synthetic training pairs: 12 steps an epoch
# Launches per training step: one generator forward (A, B) and its
# backward (C at A's shapes, B-dx and D at B's).
PER_STEP = {"instance_norm_act": A_PER_FORWARD,
            "instance_norm_act_backward": A_PER_FORWARD,
            "conv3x3": B_PER_FORWARD, "conv3x3_dgrad": B_PER_FORWARD,
            "conv3x3_wgrad": B_PER_FORWARD}
# Card against CPU, one training step at float32 compute with TF32 off
# (nf=16, 64x64, batch 2). Losses relative. Gradients: each tensor's max
# |diff| as a share of its max |grad|. The step's gradients are piecewise
# smooth: a ReLU at z ~ 0 that flips moves a gradient by a step, and in the
# low-resolution rows (8x8 and 4x4 pixels at this size) one flipped pixel
# moves a tensor by up to ~0.2 of its max. So three statistics are held:
#   median  over all tensors: a wrong scale in C or B-dx moves every tensor
#           upstream of it;
#   row0    the worst tensor of the full-resolution row (conv0_*, 4,096
#           pixels a plane; D's outputs are among them);
#   any     the worst tensor anywhere, a gross limit.
# The phase measures both sides of each limit in the same run: the float32
# floor, the CPU step again with every weight x (1 + 1e-6 N(0, 1)) under
# three seeds (1e-6 is the relative size of a float32 sum of the kernels'
# 144-864 products taken in another order, ~sqrt(K) 2^-24), and three
# faults planted in the kernels on the card (``step_faults``). It fails unless
# the card and every floor run fall within all limits and every fault
# breaks at least one.
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_LIMITS = {"median": 1e-2, "row0": 5e-2, "any": 0.5}
STEP_FLOOR_EPS = 1e-6
STEP_FLOOR_SEEDS = (14, 15, 16)


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


# Reductions (D's dk, C's dscale and doffset): float32 sums over up to
# 262,144 pixels in another order, against the largest entry.
SUM_SHARE = 1e-4

# Shapes off the serving path, for the kernels' edges: partial tiles, C and
# Cin not a multiple of 16, Co below 64, every activation, no affine.
EDGE_A = [((3, 7, 5, 24), "leaky_relu", True), ((2, 9, 13, 136), None, False),
          ((1, 1, 1, 8), "relu", True)]
EDGE_B = [((2, 37, 53, 24), 32), ((1, 9, 17, 8), 16), ((1, 40, 70, 40), 64)]


def check_share(name, got, want):
    """A reduction kernel against its plain version (D's dk, C's dscale and
    doffset): float32 sums of up to N*H*W terms in another order, within a
    share of the largest entry."""
    err = (got - want).abs().max().item()
    limit = SUM_SHARE * want.abs().max().item()
    if not (math.isfinite(err) and err <= limit):
        raise AssertionError(f"{name}: kernel and plain version disagree, "
                             f"max |diff| {err:.3e} > {limit:.3e}")
    return err


def phase_edges(torch, ka, kb, kd, seed):
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
    # Kernel C at A's edge shapes: its stats come from kernel A.
    for shape, act, affine in EDGE_A:
        c = shape[-1]
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[1]
            x = (torch.randn(shape, device="cuda", generator=gen) + 1).to(dt)
            g = torch.randn(shape, device="cuda", generator=gen).to(dt)
            s = o = None
            if affine:
                s = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
                o = 0.1 * torch.randn(c, device="cuda", generator=gen)
            _, st = ka.forward_kernel(x, s, o, act, 0.2)
            got = ka.backward_kernel(x, g, st, s, o, act, 0.2)
            torch.cuda.synchronize()
            want = ka.instance_norm_act_backward_plain(x, g, st, s, o, act=act)
            err = check_close(f"C edge {shape} {dn} {act} dx", got[0],
                              want[0], dn)
            for name, a, b in zip(("dscale", "doffset"), got[1:], want[1:]):
                check_share(f"C edge {shape} {dn} {name}", a, b)
            print(f"C edge {list(shape)} {dn} act={act} affine={affine}: "
                  f"max|diff| {err:.3e}", flush=True)
    # B-dx and D at B's edge shapes; the dx output width is the forward's
    # Cin (24, 8, 40: partial and several output-channel tiles), plus wide
    # odd Cin for D's channel tiles.
    for shape, co in EDGE_B + [((2, 19, 45, 136), 16)]:
        for in_dt, cd in ((torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.bfloat16),
                          (torch.float32, torch.float32)):
            dn, cn = str(in_dt).split(".")[1], str(cd).split(".")[1]
            x = torch.randn(shape, device="cuda", generator=gen).to(in_dt)
            g = torch.randn(shape[:3] + (co,), device="cuda",
                            generator=gen).to(in_dt)
            wt = 0.1 * torch.randn((co, shape[-1], 3, 3), device="cuda",
                                   generator=gen)
            dx = kb.dgrad_kernel(g, wt, cd)
            dk = kd.conv3x3_wgrad(x, g, compute_dtype=cd)
            torch.cuda.synchronize()
            err = check_close(f"B-dx edge {shape} co {co} {dn}/{cn}", dx,
                              kb.conv3x3_dgrad_plain(g, wt, compute_dtype=cd),
                              dn)
            err_d = check_share(f"D edge {shape} co {co} {dn}/{cn}", dk,
                                kd.conv3x3_wgrad_plain(x, g, compute_dtype=cd))
            print(f"B-dx/D edge {list(shape)} co={co} {dn}/{cn}: max|diff| "
                  f"{err:.3e} / {err_d:.3e}", flush=True)


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


def phase_train_kernels(torch, ka, kb, kd, seed, record):
    """Kernels C, B-dx and D against their plain versions at every shape of
    a training step (batch 4, float32 activations, bf16 conv operands), with
    times."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    dev = "cuda"
    c_rows, dx_rows, d_rows = [], [], []
    for (h, w, c), per_step in A_SHAPES:
        shape = (TRAIN_BATCH, h, w, c)
        x = torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
        g = torch.randn(shape, device=dev, generator=gen)
        s = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        o = 0.1 * torch.randn(c, device=dev, generator=gen)
        _, st = ka.forward_kernel(x, s, o, "relu", 0.2)
        got = ka.backward_kernel(x, g, st, s, o, "relu", 0.2)
        torch.cuda.synchronize()
        want = ka.instance_norm_act_backward_plain(x, g, st, s, o, act="relu")
        err = check_close(f"C {shape}", got[0], want[0], "float32")
        for name, a, b in zip(("dscale", "doffset"), got[1:], want[1:]):
            check_share(f"C {shape} {name}", a, b)
        nbytes = 3 * x.numel() * x.element_size()
        row = {"shape": list(shape), "dtype": "float32",
               "per_step": per_step, "max_abs_err": err, "tol": TOL["float32"],
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        row["ms"], row["call_ms"] = cuda_ms(
            lambda: ka.backward_kernel(x, g, st, s, o, "relu", 0.2))
        row["plain_ms"], _ = cuda_ms(
            lambda: ka.instance_norm_act_backward_plain(x, g, st, s, o,
                                                        act="relu"))
        # Library yardstick: autograd's backward of F.instance_norm + relu
        # on the channels_last view.
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        sl, ol = s.clone().requires_grad_(), o.clone().requires_grad_()
        yl = torch.relu(F.instance_norm(xl, weight=sl, bias=ol, eps=ka.EPS))
        gl = g.permute(0, 3, 1, 2)
        row["library_ms"], _ = cuda_ms(lambda: torch.autograd.grad(
            yl, (xl, sl, ol), gl, retain_graph=True))
        del yl
        c_rows.append(row)
        print(f"C {row['shape']}: max|diff| {err:.3e} ms {row['ms']:.4f} "
              f"plain {row['plain_ms']:.4f} library {row['library_ms']:.4f} "
              f"bound {row['bound_ms']:.4f}", flush=True)

    for cin, per_step in B_CINS:
        pix = TRAIN_BATCH * FULL_RES * FULL_RES
        x = torch.randn((TRAIN_BATCH, FULL_RES, FULL_RES, cin), device=dev,
                        generator=gen)
        g = torch.randn((TRAIN_BATCH, FULL_RES, FULL_RES, 64), device=dev,
                        generator=gen)
        wt = 0.05 * torch.randn((64, cin, 3, 3), device=dev, generator=gen)
        cd = torch.bfloat16
        dx = kb.dgrad_kernel(g, wt, cd)
        dk = kd.conv3x3_wgrad(x, g, compute_dtype=cd)
        torch.cuda.synchronize()
        err_dx = check_close(f"B-dx cin {cin}", dx,
                             kb.conv3x3_dgrad_plain(g, wt, compute_dtype=cd),
                             "float32")
        err_d = check_share(f"D cin {cin}", dk,
                            kd.conv3x3_wgrad_plain(x, g, compute_dtype=cd))
        dk2 = kd.conv3x3_wgrad(x, g, compute_dtype=cd)
        if not torch.equal(dk, dk2):
            raise AssertionError(f"D cin {cin}: two runs differ")
        flops = 2 * pix * 9 * cin * 64
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        xl = x.to(cd).permute(0, 3, 1, 2)
        gl = g.to(cd).permute(0, 3, 1, 2)
        wl = wt.to(cd)
        for rows, name, err, nbytes, fn, plain, lib in (
                (dx_rows, "B-dx", err_dx,
                 (g.numel() + x.numel()) * 4 + 9 * cin * 64 * 2,
                 lambda: kb.dgrad_kernel(g, wt, cd),
                 lambda: kb.conv3x3_dgrad_plain(g, wt, compute_dtype=cd),
                 lambda: torch.nn.grad.conv2d_input(xl.shape, wl, gl,
                                                    padding=1)),
                (d_rows, "D", err_d,
                 (g.numel() + x.numel()) * 4 + 9 * cin * 64 * 4,
                 lambda: kd.conv3x3_wgrad(x, g, compute_dtype=cd),
                 lambda: kd.conv3x3_wgrad_plain(x, g, compute_dtype=cd),
                 lambda: torch.nn.grad.conv2d_weight(xl, wl.shape, gl,
                                                     padding=1))):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            row = {"shape": [TRAIN_BATCH, FULL_RES, FULL_RES, cin], "co": 64,
                   "dtype": "float32", "compute": "bfloat16",
                   "per_step": per_step, "max_abs_err": err, "flops": flops,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            row["ms"], row["call_ms"] = cuda_ms(fn)
            row["plain_ms"], _ = cuda_ms(plain)
            row["library_ms"], _ = cuda_ms(lib)
            row["tflops"] = flops / row["ms"] / 1e9
            rows.append(row)
            print(f"{name} cin {cin}: max|diff| {err:.3e} ms {row['ms']:.4f} "
                  f"({row['tflops']:.1f} TFLOP/s) plain {row['plain_ms']:.4f} "
                  f"library {row['library_ms']:.4f} bound "
                  f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    record["kernel_c"], record["kernel_b_dx"], record["kernel_d"] = (
        c_rows, dx_rows, d_rows)
    return c_rows, dx_rows, d_rows


def write_pairs(root, split, pairs):
    from PIL import Image

    src_dir = os.path.join(root, "data", split, "source")
    tac_dir = os.path.join(root, "data", split, "tactile")
    os.makedirs(src_dir)
    os.makedirs(tac_dir)
    for i, (s, t) in enumerate(pairs):
        Image.fromarray(s).save(os.path.join(src_dir, f"s_{i:04d}.png"))
        Image.fromarray(t).save(os.path.join(tac_dir, f"t_{i:04d}.tiff"))


def launch_counts(ka, kb, kd):
    return {"instance_norm_act": ka.instance_norm_act.launches,
            "instance_norm_act_backward": ka.backward_kernel.launches,
            "conv3x3": kb.conv3x3.launches,
            "conv3x3_dgrad": kb.dgrad_kernel.launches,
            "conv3x3_wgrad": kd.conv3x3_wgrad.launches}


def reset_counts(ka, kb, kd):
    ka.instance_norm_act.launches = ka.backward_kernel.launches = 0
    kb.conv3x3.launches = kb.dgrad_kernel.launches = 0
    kd.conv3x3_wgrad.launches = 0


def phase_train(torch, ka, kb, kd, args, record):
    """train.py at its defaults through the port's CLI on cuda, then the
    trained folder through evaluate_folder."""
    from tactile_gan_torch.cli import train as train_cli
    from tactile_gan_torch.eval import runner

    out = {"pairs": TRAIN_PAIRS, "epochs": 2}
    with tempfile.TemporaryDirectory() as root:
        write_pairs(root, "train", chart_pairs(TRAIN_PAIRS, FULL_RES,
                                               args.seed + 5))
        write_pairs(root, "test", chart_pairs(8, FULL_RES, args.seed + 6))
        # The library convs as a user runs them: cuDNN's TF32 default.
        torch.backends.cudnn.allow_tf32 = True
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ka, kb, kd)
        t0 = time.perf_counter()
        trainer = train_cli.main(["--data", os.path.join(root, "data"),
                                  "--total_epochs", "2", "--epoch_constant",
                                  "1", "--folder_save", "train_smoke",
                                  "--seed", str(args.seed)])
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        counts = launch_counts(ka, kb, kd)
        torch.backends.cudnn.allow_tf32 = False
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        cfg = trainer.cfg
        steps = trainer.state.step
        out.update(steps=steps, steps_per_epoch=trainer.steps_per_epoch,
                   launches=counts, epoch_seconds=trainer.epoch_seconds,
                   config={k: getattr(cfg, k) for k in (
                       "gen", "nf", "batch_size", "image_size", "loss",
                       "lambda_gp", "lambda_per", "version", "compute_dtype",
                       "host_aug")})
        want = {k: v * steps for k, v in PER_STEP.items()}
        if counts != want:
            raise AssertionError(f"training launches {counts}, expected "
                                 f"{want} ({steps} steps)")
        if (cfg.gen, cfg.nf, cfg.batch_size, cfg.image_size) != (
                "UNet++", 64, TRAIN_BATCH, FULL_RES) or not trainer.vgg_random_fallback:
            raise AssertionError(f"not the default training config: {cfg}")
        model_dir = cfg.models_dir()
        losses = {k: np.load(os.path.join(model_dir, f"{k}loss.npy")).tolist()
                  for k in ("gen", "disc", "l1", "gp", "per")}
        out["losses"] = losses
        if not all(len(v) == 2 and all(math.isfinite(x) for x in v)
                   for v in losses.values()):
            raise AssertionError(f"training losses {losses}")
        if not (min(losses["gp"]) > 0 and min(losses["per"]) > 0):
            raise AssertionError(f"GP or perceptual term missing: {losses}")
        for name in ("final_model.pth", "params.txt"):
            if not os.path.exists(os.path.join(model_dir, name)):
                raise AssertionError(f"{name} not written")
        ms = trainer.epoch_seconds[1] * 1e3 / trainer.steps_per_epoch
        out["ms_per_step"] = ms
        out["img_per_s"] = TRAIN_BATCH * 1e3 / ms
        print(f"train: {steps} steps in {out['train_s']:.2f} s (epochs "
              f"{trainer.epoch_seconds[0]:.2f} s, {trainer.epoch_seconds[1]:.2f}"
              f" s); steady state {ms:.2f} ms/step = {out['img_per_s']:.2f} "
              f"img/s at batch {TRAIN_BATCH}; peak memory "
              f"{out['peak_mem_bytes'] / 2**30:.2f} GiB; launches {counts}; "
              f"losses {losses}", flush=True)

        reset_counts(ka, kb, kd)
        metrics = runner.evaluate_folder("train_smoke", work_root=root,
                                         eval_batch=4, device="cuda")
        torch.cuda.synchronize()
        serve_counts = launch_counts(ka, kb, kd)
        out["serve_launches"] = serve_counts
        out["serve_metrics"] = metrics
        forwards = 2  # 8 test pairs at eval_batch 4
        if (serve_counts["instance_norm_act"], serve_counts["conv3x3"]) != (
                A_PER_FORWARD * forwards, B_PER_FORWARD * forwards) or not all(
                math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"serving the trained folder: launches "
                                 f"{serve_counts}, metrics {metrics}")
        print(f"served the trained folder: {metrics}; launches {serve_counts}",
              flush=True)
    record["train"] = out
    return out


def step_faults(ka, kb):
    """The faults planted on the card to show that the step check catches a
    wrong kernel: name -> (module, attribute, faulty replacement)."""
    c_orig, dx_orig, d_orig = ka.backward_kernel, kb.dgrad_kernel, \
        kb.conv3x3_wgrad

    def c_dx_scaled(*a):
        dx, dscale, doffset = c_orig(*a)
        return dx * 1.01, dscale, doffset

    def d_last_tile_dropped(x, g, *, compute_dtype):
        # The last 8x32-pixel tile of g: one of D's 32 chunks at 64x64,
        # batch 2, missing from the sum.
        g = g.clone()
        g[-1, -8:, -32:] = 0
        return d_orig(x, g, compute_dtype=compute_dtype)

    return {"C dx x 1.01": (ka, "backward_kernel", c_dx_scaled),
            "B-dx x 1.01": (kb, "dgrad_kernel",
                            lambda *a: dx_orig(*a) * 1.01),
            "D last tile dropped": (kb, "conv3x3_wgrad", d_last_tile_dropped)}


def phase_step_card_vs_cpu(torch, ka, kb, args, record):
    """One training step on the card and on the CPU from the same weights
    and injected draws: nf=16, 64x64, batch 2, float32 compute, TF32 off,
    learning rate 0. Compares the losses and every gradient before the Adam
    update, beside the float32 floor and the planted faults."""
    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import (
        create_discriminator, create_generator,
    )
    from tactile_gan_torch.models.vgg import load_vgg_features
    from tactile_gan_torch.train.state import TrainState, make_optimizer
    from tactile_gan_torch.train.step import METRICS, build_train_step

    nf, size, batch = 16, 64, 2
    cfg = TrainConfig(nf=nf, batch_size=batch, image_size=size,
                      compute_dtype="float32")
    rng = np.random.default_rng(args.seed + 11)
    src = torch.from_numpy(rng.integers(0, 255, (batch, size, size, 3),
                                        dtype=np.uint8))
    tgt = torch.from_numpy(rng.integers(0, 255, (batch, size, size, 3),
                                        dtype=np.uint8))
    noise = torch.from_numpy(rng.standard_normal((batch, 9, 9, 1))
                             .astype(np.float32))
    alpha = torch.from_numpy(rng.uniform(size=(batch, 1, 1, 1))
                             .astype(np.float32))

    def one_step(dev, eps=0.0, perturb_seed=0):
        """(losses, {"G"|"D": {name: grad}}) of one step on dev, every
        weight scaled by (1 + eps N(0, 1)) when eps is given."""
        gen = create_generator("UNet++", nf=nf, compute_dtype=torch.float32)
        disc = create_discriminator("patch", nf=nf)
        init_weights(gen, torch.Generator().manual_seed(args.seed + 12))
        init_weights(disc, torch.Generator().manual_seed(args.seed + 13))
        if eps:
            g = torch.Generator().manual_seed(args.seed + perturb_seed)
            with torch.no_grad():
                for p in list(gen.parameters()) + list(disc.parameters()):
                    p.mul_(1 + eps * torch.randn(p.shape, generator=g))
        gen.to(dev)
        disc.to(dev)
        opt_g = make_optimizer(gen.parameters(), cfg.lr, cfg.beta1)
        opt_d = make_optimizer(disc.parameters(), cfg.lr, cfg.beta1)
        grads = {}
        for name, opt, model in (("G", opt_g, gen), ("D", opt_d, disc)):
            names = [n for n, _ in model.named_parameters()]

            def hook(o, _args, _kwargs, name=name, names=names):
                grads[name] = {n: p.grad.detach().cpu().clone() for n, p in
                               zip(names, o.param_groups[0]["params"])}
            opt.register_step_pre_hook(hook)
        # Learning rate 0: both sides score G against the same D. Adam's
        # first update is about lr * sign(grad), which would turn rounding
        # noise in near-zero D gradients into 2 lr weight differences.
        step = build_train_step(cfg, lambda _step: 0.0,
                                load_vgg_features(device=dev))
        losses = step(TrainState(gen, disc, opt_g, opt_d), src.to(dev),
                      tgt.to(dev), apply_gp=True, label_noise=noise.to(dev),
                      gp_alpha=alpha.to(dev)).cpu()
        return losses, grads

    cpu = one_step("cpu")

    def reading(res):
        """The run against the CPU step: loss rel err and the three
        gradient statistics (each share = max|diff| / max|grad|)."""
        (la, ga), (lb, gb) = res, cpu
        shares = {f"{net} {n}": ((ga[net][n] - want).abs().max()
                                 / want.abs().max().clamp_min(1e-30)).item()
                  for net in ("G", "D") for n, want in gb[net].items()}
        row0 = {k: v for k, v in shares.items() if k.startswith("G conv0_")}
        any_name = max(shares, key=shares.get)
        row0_name = max(row0, key=row0.get)
        return {"losses": dict(zip(METRICS, la.tolist())),
                "loss_rel_err": ((la - lb).abs() / lb.abs()).max().item(),
                "median": float(np.median(list(shares.values()))),
                "row0": row0[row0_name], "row0_tensor": row0_name,
                "any": shares[any_name], "any_tensor": any_name}

    def within(r):
        return r["loss_rel_err"] <= STEP_LOSS_RTOL and all(
            r[k] <= lim for k, lim in STEP_GRAD_LIMITS.items())

    runs = {"card": reading(one_step("cuda"))}
    for s in STEP_FLOOR_SEEDS:
        runs[f"floor seed {s}"] = reading(one_step("cpu", STEP_FLOOR_EPS, s))
    for name, (module, attr, faulty) in step_faults(ka, kb).items():
        orig = getattr(module, attr)
        faulty.launches = 0  # the wrappers count on their module's name
        setattr(module, attr, faulty)
        try:
            runs[f"fault {name}"] = reading(one_step("cuda"))
        finally:
            setattr(module, attr, orig)
    for name, r in runs.items():
        r["within_limits"] = within(r)
        print(f"training step vs CPU, {name}: loss rel err "
              f"{r['loss_rel_err']:.3e}; gradient shares: median "
              f"{r['median']:.3e}, row0 {r['row0']:.3e} at {r['row0_tensor']}"
              f", any {r['any']:.3e} at {r['any_tensor']}; within limits "
              f"{r['within_limits']}", flush=True)
    out = {"losses_cpu": dict(zip(METRICS, cpu[0].tolist())), "runs": runs,
           "grad_tensors": sum(len(v) for v in cpu[1].values()),
           "loss_rtol": STEP_LOSS_RTOL, "grad_limits": STEP_GRAD_LIMITS,
           "floor_eps": STEP_FLOOR_EPS}
    record["step_card_vs_cpu"] = out
    print(f"limits: loss rel err {STEP_LOSS_RTOL}, gradient shares "
          f"{STEP_GRAD_LIMITS} over {out['grad_tensors']} tensors", flush=True)
    missed = [n for n, r in runs.items() if n.startswith("fault") and
              r["within_limits"]]
    outside = [n for n, r in runs.items() if not n.startswith("fault") and
               not r["within_limits"]]
    if outside or missed:
        raise AssertionError(f"training step check: outside the limits "
                             f"{outside}; planted faults not caught {missed}")
    return out


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
        write_pairs(root, "test", pairs)

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


def kernel_entry(name, source, replaces, launches, rows, weight, per, card):
    """One entry of the kernels line: sums over the rows' launches of one
    training step (``weight`` gives each row's launch count)."""
    heaviest = max(rows, key=lambda r: r["bound_ms"] * weight(r))
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: sum(r[k] * weight(r) for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": heaviest["bound_by"], "per": per, "card": card}


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
    from tactile_gan_torch.ops.kernels import conv3x3_wgrad as kd
    from tactile_gan_torch.ops.kernels import instance_norm as ka

    # f32 results are compared: no TF32 in the library convs or matmuls
    # (the training phase turns cuDNN's TF32 default back on for its run).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed, "phase_s": {}}
    t0 = time.perf_counter()
    build.build_all(["instance_norm_act", "conv3x3", "conv3x3_wgrad"])
    record["build_s"] = time.perf_counter() - t0
    print(f"built kernels in {record['build_s']:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    def timed(name, fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        record["phase_s"][name] = time.perf_counter() - t
        print(f"phase {name}: {record['phase_s'][name]:.1f} s", flush=True)
        return res

    timed("edges", phase_edges, torch, ka, kb, kd, args.seed)
    a_rows, b_rows = timed("kernels_serving", phase_kernels, torch, ka, kb,
                           args.seed, record)
    c_rows, dx_rows, d_rows = timed("kernels_training", phase_train_kernels,
                                    torch, ka, kb, kd, args.seed, record)
    train = timed("train", phase_train, torch, ka, kb, kd, args, record)
    serve = timed("serve", phase_serve, torch, ka, kb, args, record)
    timed("step_card_vs_cpu", phase_step_card_vs_cpu, torch, ka, kb, args,
          record)

    # Launches over the main path: the training run, the trained folder
    # served, and the serving runs.
    launches = dict(train["launches"])
    for k in ("instance_norm_act", "conv3x3"):
        launches[k] += train["serve_launches"][k]
    launches["instance_norm_act"] += sum(r["launches_a"] for r in serve["runs"])
    launches["conv3x3"] += sum(r["launches_b"] for r in serve["runs"])
    fwd = serving_rows(TRAIN_BATCH)
    a_step = [r for r in a_rows if fwd(r)]
    b_step = [r for r in b_rows if fwd(r)]
    per = ("one training step at batch 4, 256x256 (all its launches), "
           "float32 activations")
    pallas = "tactile_gan_tpu/ops/pallas/"
    csrc = "tactile_gan_torch/csrc/"
    kernels = [
        kernel_entry("instance_norm_act", csrc + "instance_norm_act.cu",
                     pallas + "instance_norm.py:492", launches["instance_norm_act"],
                     a_step, lambda r: r["per_forward"], per, card),
        kernel_entry("instance_norm_act_backward", csrc + "instance_norm_act.cu",
                     pallas + "instance_norm.py:383",
                     launches["instance_norm_act_backward"], c_rows,
                     lambda r: r["per_step"], per, card),
        kernel_entry("conv3x3", csrc + "conv3x3.cu", pallas + "conv3x3.py:394",
                     launches["conv3x3"], b_step, lambda r: r["per_forward"],
                     per + ", bf16 operands", card),
        kernel_entry("conv3x3_dgrad", csrc + "conv3x3.cu",
                     pallas + "conv3x3.py:394", launches["conv3x3_dgrad"],
                     dx_rows, lambda r: r["per_step"],
                     per + ", bf16 operands", card),
        kernel_entry("conv3x3_wgrad", csrc + "conv3x3_wgrad.cu",
                     pallas + "conv3x3.py:509", launches["conv3x3_wgrad"],
                     d_rows, lambda r: r["per_step"],
                     per + ", bf16 operands", card),
    ]
    record["kernels"] = kernels
    record["main_path_launches"] = launches
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
