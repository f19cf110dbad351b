#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (tactile_gan_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--images 126]

Phases, each raising on failure (each prints its seconds):
  0. build the hand-written kernels from tactile_gan_torch/csrc (one nvcc
     per source, in parallel) and print ptxas's registers and spills for
     each kernel;
  1. hold each kernel against its plain PyTorch version on the card at
     shapes off the main path (partial tiles, channel counts that are not a
     multiple of 64 or of 8, several output-channel tiles), in float32 and
     bfloat16: A and C (at their slab plan's edges too: a share that
     streams a part, several slabs, 1x1 images; a fault planted on A, its
     streamed part left unwritten, must fail the check) and B forward (B
     with bf16 operands at Cin % 8 == 0 and Co
     16/32/64 is the wgmma body of csrc/conv3x3_fwd_sm90.cu, also at W not a
     multiple of 64, H not a multiple of 4, Cin 8 to 72 and batch 3; B at Co
     off 16/32/64 or Cin off multiples of 8 is conv3x3.cu's tail), C
     (instance-norm backward), B-dx and D (the conv's input and weight
     gradients); B-dx and kernel E on the wgmma body at Co 16 to 384 with a
     partial last tile, Cin 8 to 72, W not a multiple of 64, H 1 and 3,
     batch 3, both input dtypes (B-dx writes the input's dtype, E float32);
     and kernel E (conv3x3_p1, conv3x3_p1_h) at Cin and Co from 1 to 96, odd
     H and W, partial tiles, batches of 1 and 3, float32 and bf16 inputs,
     both compute dtypes, through both names; D with bf16 operands (the
     wgmma kernel of csrc/conv3x3_wgrad_sm90.cu) also at W not a multiple of
     its 64-column strip, H 1 and 3, batch 3, Cin 72 (a second, partly full
     ci tile) and runs that cross strips, both input dtypes, two runs equal;
  2. the same at every shape the serving forward and the training step give
     each kernel, with times: the kernel, its plain version and one library
     call computing the same function (a yardstick only: the port never
     calls it), beside the least time the card could take (bytes /
     3.35 TB/s or flops / peak), and B's forward at the training shapes of
     nf 32 and 16 (Co 32 and 16); A and C at batch 4 and 256^2 give equal
     bits on two runs; faults planted on A (one block's partial left out of
     the merge), on C (the same, and its streamed part left unwritten), two
     on the wgmma forward's output, two on B-dx (x 1.01, one Co tile left
     unwritten) and three on the wgmma weight gradient must fail the
     per-shape check; the training step's A, C, B, B-dx and D also on bf16
     activations (what --bf16_resident gives them), timed beside their
     bf16 bound, each bf16 output within 2^-7 of itself plus 2^-9 of the
     largest entry (``check_bf16``), two faults planted on each (x (1 +
     2^-6); the entries under a quarter of the largest x (1 + 2^-4)) and
     one on D's bf16 run (x (1 + 2^-10)) failing the check; where
     --baseline gives the parent's JSON from the same
     call, the rows of A, C, B, B-dx and D (and E in phase 6) print the
     parent's time beside their own;
  3. train: synthetic chart pairs are written as data/train under a
     temporary work root and ``tactile_gan_torch.cli.train.main`` runs at
     its defaults (UNet++ nf=64, batch 4, 256x256, ls loss with label
     smoothing, v1 perceptual loss on the port's seeded VGG fallback, GP
     every epoch) for two epochs on cuda, with --checkpoint_interval 1: the
     step replays its CUDA graph after one eager step, the batches come
     through the prefetcher. The launch counters must show exactly 30 A,
     30 C, 9 B, 9 B-dx and 9 D launches a step; the losses must be finite,
     every artifact written and model_1.pth and model_2.pth read back. Then
     the same run at --reg_every 2 (both GP variants must capture in one
     trainer) and through the eager step (the trainer's test hook), with
     the same counts. For each run: ms per step and img/s (epoch 2, the
     host pipeline included), peak device memory and each variant's
     capture seconds. The first run's folder is then served through
     evaluate_folder in the same process (train -> test end to end), with
     the serving launch counts;
  4. serve: a UNet++ nf=64 generator with N(0, 0.02) weights from --seed is
     loaded through the port's load_model on cuda and timed alone at batch 1
     and 4; its graphed serving programs (eval/graph.py, u8_eval and f32)
     must equal the same programs run eagerly on the card bit for bit at
     batch 1 and 4 (the capture's batch, a replay of another, the first
     again); then evaluate_folder (the test.py flow) runs over synthetic
     chart pairs at eval_batch 1 and 4, eager and graphed in turns (eager,
     graphed, graphed, eager), with TACTILE_EVAL_TIMING=1 and its line
     printed (the plots are skipped where matplotlib is not installed; the
     runner says so), with the launch counts of both forward kernels exact
     under replay, and the graphed run's files (every PNG and eval.txt; 126
     pairs leave a padded tail at eval_batch 4) must equal the eager run's
     byte for byte; a second test_model with the same forward must make no
     new capture; a weakref to the forward's programs must be dead after
     the forward is deleted; two faults planted on the programs must change
     the PNGs against the eager run: a replay that skips the copy into its
     static input, and the graph's own output (no clone) handed to a drain
     that runs DRAIN_LAG_S late; the card's output for one image
     must match the same weights run on the CPU through the plain path;
  5. other widths: for nf 8, 12, 24, 32 and 128, cli.train runs one epoch
     of two steps at 64x64, batch 2, with --debug_nans (at nf 32 also
     --profile_dir, which must write a trace), cli.test serves the
     trained folder, and the card's forward of the trained generator is held
     to the CPU's. At nf <= 64 row 0 runs kernels B, B-dx and D (the tail
     at Co 8, 12, 24; the wgmma body at Co 32) and the launch counts must be
     those of the default width; at nf 128 (Co > 64, the library conv, as
     the JAX package's XLA conv) no B, B-dx or D launch may happen;
  6. probe_conv: the conv probe entry point
     (``tactile_gan_torch.cli.probe_conv``, the port of
     scripts/probe_pallas_conv.py) at its defaults, B4, 256x256, three
     (Cin, Co) pairs, on cuda. The launch counters must equal the calls the
     probe made through conv3x3_p1, conv3x3_p1_h and conv3x3 (kernels E and
     B); then E, through both names, against its plain version at the
     probe's inputs, with its ms, the plain and library ms and the bound; a
     fault planted on E (x 1.01) must fail that check;
  7. one training step on the card against the same step on the CPU (plain
     versions), from the same weights and injected draws, at nf=16, 64x64,
     batch 2, float32 compute with TF32 off, learning rate 0: the losses
     and every gradient before the Adam update must agree within limits
     (median tensor, worst tensor of the full-resolution row, worst tensor)
     that the same phase shows to lie between the step's float32 floor
     (the CPU step with perturbed weights) and three faults planted in the
     kernels;
  8. graph_vs_eager: four training steps at train.py's defaults from one
     initial state, batch sequence and generator seed, the learning rate
     x0.8 from the third step: eager twice (the floor: cuDNN's backward
     sums in no fixed order) and graphed (train/graph.py). Each step's
     losses and every parameter after the last step must agree within
     limits set from the floor (GVE_FACTOR times it, at least GVE_MIN), and
     three faults planted on the graphed step must break them (or be
     refused at capture): the relayout cache read across the capture, the
     learning rate assigned instead of filled, the generator not
     registered with the graph (torch refuses that capture);
  9. other_generators: UNet and BCDUNet at nf 64, batch 4, 256x256, every
     other flag at train.py's defaults. For each: A and C against their
     plain versions at every norm shape of its forward and step (recorded
     from a forward on the card; affine for UNet, non-affine for BCDUNet),
     timed beside the bound, the plain version and the library
     (F.instance_norm + relu, its autograd backward), with their sums a
     step; at UNet's 2x2x512 (one pixel a block) a fault planted on A and
     on C, block 0's partial left out of the merge, must fail the check;
     cli.train --gen G for two epochs on 16 synthetic pairs, graphed, with
     --checkpoint_interval 1: exactly 28 A and 28 C launches a UNet step,
     14 and 14 a BCDUNet step, no B, B-dx or D; finite losses, every
     artifact, model_1.pth and model_2.pth read back; the trained folder
     served through evaluate_folder (8 pairs at eval_batch 4, graphed)
     with its counts; its graphed programs equal to the eager ones bit for
     bit at batch 1 and 4 (as in serve); its forward on the card against
     the CPU's at batch 1 (the serve phase's limits); four graphed steps against four eager ones
     within graph_vs_eager's limits, where BCDUNet's conv biases that feed
     a non-affine norm (true gradient 0) are left out of the parameters and
     their gradients held below 1e-6 of the largest gradient of their
     conv's weight in every run;
 10. variants: cli.train at nf 64, batch 4, 256x256 on 16 synthetic pairs,
     graphed, for 2 epochs, once for each of --version 2 --lambda_per 1,
     --loss ce, --loss w --no_label_smoothing, --loss hinge,
     --legacy_label_cache, --disc_same_pad, --no-host_aug and
     --space_to_depth, each with ms/step, img/s, peak memory and capture
     seconds: exactly 30 A, 30 C, 9 B, 9 B-dx and 9 D launches a step (30,
     30 and no B, B-dx or D under --space_to_depth, whose row 0 is 128
     channels wide), finite losses, a perceptual loss above 0 (pan_loss
     under version 2, the VGG term otherwise); the --space_to_depth folder served through cli.test
     (graphed) with its counts, its graphed programs equal to the eager
     ones bit for bit and its forward on the card against the CPU's;
     four graphed steps against four eager ones for --version 2,
     --no-host_aug and --space_to_depth within graph_vs_eager's limits; the
     device augmentation on the card against the CPU on one uint8 batch
     and injected draws (source within 1e-4, at most 0.1% of the mask off)
     with a planted fault, the mask sampled bilinearly, that must break the
     mask limit; A and C at the folded row's shapes (128x128x128 at nf 64,
     128x128x64 at nf 32) against their plain versions, timed; at nf 32,
     64x64, batch 2, two --space_to_depth steps with UNet++'s counts and B,
     B-dx and D at every Cin of the folded 32x32x64 row against their plain
     versions; cli.two_step_test over synthetic charts with their three
     components (two seeded UNet++ nf 64 folders, stage 1 rgb, stage 2 ch)
     with its counts, eval.txt and elm/; each stage and the chain on the
     card against the CPU's at batch 1 (the chain in bf16 within twice
     what bf16 compute moves it on the CPU, at least the serve limits); the
     chain's graphed programs (one graph for both stages, kept on stage 1
     and found again by a new ChainedForward) equal to the eager chain bit
     for bit at batch 1 and 4;
     cli.visualize_augmentation on the card over two training pairs;
 11. parallel (tactile_gan_torch/parallel, utils/dist_ckpt.py, entry.py):
     (a) cli.train at its defaults, graphed, for 4 steps (8 pairs, 2
     epochs) without a process group and then as the one rank of an NCCL
     group in this process (a file store), cuDNN deterministic in both:
     exactly 30 A, 30 C, 9 B, 9 B-dx and 9 D launches a step, the gradient
     all-reduces captured in the graph, both runs' parameters and losses
     equal bit for bit, each run's graphed step under the profiler (host
     wall, busy, idle share, host launches); (b) data parallelism over 2
     gloo ranks sharing cuda:0 (eager), UNet++ nf 64, 2 rows a rank at
     256x256, float32 compute with cuDNN deterministic, 4 steps on
     injected draws, against the one-rank batch-4 step in this process
     within GVE_FACTOR times a floor, at least GVE_MIN: the one-rank run
     on the batch with its rows (and draws) permuted; each rank with the
     default width's counts a step; the fault D's all-reduce left out must
     fall outside; (c) tensor parallelism 1x2 (every conv of 256 channels
     or more split) for 2 steps, the same way, the floor the larger of the
     permuted run and the one-rank run with each such conv computed as two
     convs on the halves of its weight, with the fault of a gather whose
     backward sums; in (b) and (c) every rank's losses, and in (c) its
     gradients of the parameters that are not split (before their average
     over the ranks), must equal rank 0's bits; (d) a DCP
     checkpoint (--ckpt_backend orbax) saved after (c) and restored at its
     latest step into a fresh sharded state must equal it; (e) entry() on
     the card, dryrun_multichip(4) (4 gloo ranks on cuda:0: one card) and
     dryrun_multichip(1) (NCCL, a card a rank).

 12. bench (run right after phase 0, in a subprocess, on the kernels it
     built): ``python -m tactile_gan_torch.cli.bench --budget_s 300``
     must print exactly one JSON line on stdout with the five keys of
     bench.py's result, a finite positive value (the median of at least 3
     trials), the card's name and power limit, 0 < mfu_estimate <= 1.05,
     a number in every throughput matrix entry and 30 A, 30 C, 9 B, 9 B-dx
     and 9 D launches in one eager b4 step; then the step's flop count at
     nf 8, 64x64, batch 2 on the card (FlopCounterMode plus the conv
     wrappers' counts) must equal the CPU's through the plain versions.
     The line is printed and written to bench.json beside --out.
 13. quality (run right after train): ``tactile_gan_torch.cli.quality``,
     the port of scripts/quality_run.sh, at --batch 4 --version 2 --epochs
     30 --seed 21 in a temporary work root: the synthetic chart set (96
     training and 16 test pairs at 256x256), UNet++ nf 64 trained for 30
     epochs graphed, the folder served through cli.test at eval_batch 1
     (graphed). Exactly 30 A, 30 C, 9 B, 9 B-dx and 9 D launches a
     training step and 30 A and 9 B a served image; every loss of every
     epoch finite; L1 at the last epoch at most a quarter of the first;
     mean Dice at or above QUALITY_DICE_FLOOR = 0.9850, the JAX package's
     record of this config on a TPU (0.9950, BASELINE.md) less 0.01, a
     margin that the port's two-seed spread must sit well inside. The
     run's JSON line is printed.
 14. resident (run right after graph_vs_eager): train.py's defaults with
     --bf16_resident --disc_bf16 (bf16 activations in every UNet++ row and
     in D) beside the default step, each through
     ``utils/profiling.py``'s ``fixed_step``, graphed: exactly 30 A, 30 C,
     9 B, 9 B-dx and 9 D launches a step over RESIDENT_STEPS steps, every
     one of the resident step's on bf16 activations (the wrappers'
     ``.bf16_launches``) and none of the default's; ms a step, busy,
     idle share, peak memory and the device ms by kernel family of both
     under the profiler; RESIDENT_BIT_STEPS graphed resident steps equal
     to as many eager ones bit for bit (cuDNN deterministic), the stale
     relayout planted on the graphed run breaking that; one resident step
     on the card against the CPU's (nf 16, 64x64, batch 2, lr 0), read
     over whole networks (RESIDENT_STATS), within RESIDENT_FACTOR times a
     floor measured in the same run, three faults planted in the kernels
     outside it (C's dx x 1.1, B-dx and D x 1.25). The kernels' bf16
     shapes are checked in phase 2, and phase 11's dry runs run the dry
     run's phase 2 resident.

Then, not a gate, one call of kernel A and one of C are captured into a
CUDA graph (torch.cuda.graph) and replayed; whether each captures is
printed. Prints the card (nvidia-smi name and power limit), one JSON line of kernel
numbers, and last {"ok": true, "device": {...}}. Details go to --out
(perf_out/chip_smoke.json). Exits non-zero without a result when no CUDA
device is available or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
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
# Kernel A and kernel B launches a forward of each generator at nf 64:
# UNet++ 15 double convs and its row-0 convs; UNet 7 DownBlocks and 7
# UpBlocks, BCDUNet 7 double convs, two norms each, every conv on the
# library (the JAX package packs only UNet++'s row 0).
A_PER_FORWARD_OF = {"UNet++": A_PER_FORWARD, "UNet": 28, "BCDUNet": 14}
B_PER_FORWARD_OF = {"UNet++": B_PER_FORWARD, "UNet": 0, "BCDUNet": 0}


def per_step(gen):
    """Launches a training step of ``gen``: one generator forward (A, B)
    and its backward (C at A's shapes, B-dx and D at B's)."""
    a, b = A_PER_FORWARD_OF[gen], B_PER_FORWARD_OF[gen]
    return {"instance_norm_act": a, "instance_norm_act_backward": a,
            "conv3x3": b, "conv3x3_dgrad": b, "conv3x3_wgrad": b,
            "conv3x3_p1": 0, "conv3x3_p1_h": 0}


PER_STEP = per_step("UNet++")
# Kernel E's output against the library conv in the probe: the library
# rounds its output to bf16 (2^-9 of each value) and sums the same bf16
# products in another order; relative to the output's max.
PROBE_REL_ERR = 2.0 ** -7
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
# C 12 and 20: off multiples of 8, padded by the wrappers of A and C. For A
# and C's slab plan: 512^2 x 64 streams a part of each block's share in both
# directions and dtypes, batch 8 at 128^2 x 128 takes several slabs in both,
# and a batch of 1x1 images.
EDGE_A = [((3, 7, 5, 24), "leaky_relu", True), ((2, 9, 13, 136), None, False),
          ((1, 1, 1, 8), "relu", True), ((2, 9, 13, 12), "relu", True),
          ((3, 5, 7, 20), "leaky_relu", False),
          ((1, 512, 512, 64), "relu", True),
          ((8, 128, 128, 128), "leaky_relu", True),
          ((5, 1, 1, 32), None, False)]
# The last four take the tail instantiation for B and B-dx (Co off 16/32/64
# or Cin off multiples of 8: UNet++ row 0 at nf 8, 12, 24) and D's padding.
EDGE_B = [((2, 37, 53, 24), 32), ((1, 9, 17, 8), 16), ((1, 40, 70, 40), 64),
          ((2, 37, 53, 12), 12), ((1, 9, 17, 36), 24), ((2, 19, 45, 64), 8),
          ((1, 7, 9, 3), 40)]
# D with bf16 operands (the wgmma kernel), (N, H, W, Cin) and Co: W not a
# multiple of its 64-column strip, H 1 and 3, batch 3, Cin 72 (two ci tiles,
# the second 8 channels full), a single pixel, and Cin 1024 (16 ci tiles,
# 8 chunks: runs of 15 rows that cross the 20-row strips).
EDGE_D_SM90 = [((3, 3, 70, 72), 64), ((1, 1, 130, 64), 64),
               ((2, 3, 63, 8), 16), ((3, 17, 200, 136), 40),
               ((1, 1, 1, 8), 8), ((2, 20, 130, 1024), 64)]
# B's forward with bf16 operands (the wgmma body), (N, H, W, Cin) and Co:
# W not a multiple of its 64-pixel tile, H not a multiple of its 4 rows (1
# and 3 among them), Cin 8 to 72 (8, 24, 40, 72: a slice half empty), batch
# 3, a single pixel, every Co tile width.
EDGE_B_SM90 = [((3, 7, 65, 8), 64), ((1, 9, 130, 40), 64),
               ((2, 5, 17, 64), 64), ((3, 13, 66, 16), 64), ((1, 1, 1, 8), 64),
               ((3, 3, 70, 24), 32), ((1, 1, 130, 72), 16),
               ((2, 6, 63, 40), 32), ((3, 5, 129, 8), 16)]
# B-dx on the wgmma body, (N, H, W) of g and the forward's (Cin, Co): the dx
# width (the forward's Cin) 16, 32, 40 (a partial tile of 64), 96 (one whole
# tile and a half) and 384 (six tiles) over K = the forward's Co 16/32/64,
# with the shapes of EDGE_B_SM90.
EDGE_DX_SM90 = [((3, 7, 65), 16, 64), ((1, 1, 130), 32, 16),
                ((2, 3, 63), 40, 32), ((3, 5, 70), 96, 64),
                ((1, 3, 129), 384, 64), ((1, 1, 1), 40, 16),
                ((2, 9, 17), 72, 32)]
# Kernel E on the wgmma body (bf16 compute, Cin % 8 == 0), (N, H, W), Cin and
# Co: Co 16/32/40/96/384 (partial last tiles, six tiles), odd Co, Cin 8 to 72.
EDGE_E_SM90 = [((3, 7, 65), 8, 16), ((1, 1, 130), 24, 32),
               ((2, 3, 63), 40, 40), ((3, 5, 70), 72, 96),
               ((1, 3, 129), 24, 384), ((1, 9, 37), 8, 5), ((2, 6, 64), 72, 17)]
# Kernel E: every (Cin, Co) of these, plus one wider pair (two output-channel
# tiles), at (N, H, W) taken in turn from E_NHW (odd sizes, partial 8x32 and
# 8x16 tiles, a single pixel, batches of 1 and 3).
E_CIN = (1, 3, 5, 13, 32, 64)
E_CO = (1, 5, 6, 24, 40, 64)
E_NHW = ((1, 9, 37), (3, 17, 45), (1, 1, 1), (3, 7, 5), (1, 33, 31))


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


def norm_plan(ka, shape, dtype, inputs):
    """The slab plan kernel A (inputs 1) or C (2) takes at ``shape``."""
    n, h, w, c = shape
    return ka.launch_plan(n, h * w, c + (-c) % 8, dtype, inputs)


def fmt_plan(plan):
    return (f"{plan.ips} image(s) a slab, {plan.grid} blocks, share "
            f"{plan.share} px, {plan.streamed} streamed, {plan.smem} B smem")


def streamed_unwritten(y, plan):
    """y with every block's streamed pixels zeroed: the output of a kernel
    that skipped writing the part of its share it does not keep."""
    out = y.clone()
    flat = out.view(out.shape[0], -1, out.shape[-1])
    hw = flat.shape[1]
    for j in range(plan.bpi):
        lo = j * plan.share + plan.resident
        flat[:, lo:min(hw, (j + 1) * plan.share)] = 0
    return out


def partial_left_out(torch, ka, x, g, stats, s, o, act, plan):
    """Kernel A's y (g None) or C's dx as a kernel would give them that
    merged image 0's statistics without its first block's partial (its
    first ``share`` pixels), dividing by H*W all the same."""
    n, h, w, c = x.shape
    x0 = x[0].float().reshape(h * w, c)
    kept = torch.ones(h * w, dtype=torch.bool, device=x.device)
    kept[:plan.share] = False
    if g is None:
        mean = x0[kept].mean(0)
        var = (x0[kept] - mean).square().sum(0) / (h * w)
        rstd = torch.rsqrt(var + ka.EPS)
        y = ka._activate((x0 - mean) * rstd * s + o, act, 0.2)
        out = ka.instance_norm_act_plain(x, s, o, act=act).clone()
        out[0] = y.reshape(h, w, c).to(out.dtype)
        return out
    mean, rstd = stats[0, :, 0], stats[0, :, 1]
    xh = (x0 - mean) * rstd
    z = xh * s + o
    g0 = g[0].float().reshape(h * w, c)
    dz = torch.where(z > 0, g0, torch.zeros_like(g0)) if act == "relu" \
        else g0
    m1 = dz[kept].sum(0) * s / (h * w)
    m2 = (dz * xh)[kept].sum(0) * s / (h * w)
    out = ka.instance_norm_act_backward_plain(x, g, stats, s, o,
                                              act=act)[0].clone()
    out[0] = (rstd * (dz * s - m1 - xh * m2)).reshape(h, w, c).to(out.dtype)
    return out


def phase_edges(torch, ka, kb, kd, seed, record):
    """Kernel vs plain version at shapes off the serving path; a fault
    planted on A and on C where a share streams a part."""
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
            want = ka.instance_norm_act_plain(x, s, o, act=act)
            err = check_close(f"A edge {shape} {dn} {act}", y, want, dn)
            plan = norm_plan(ka, shape, dt, 1)
            if plan.streamed and dt == torch.float32 \
                    and "norm_faults_a_streamed" not in record:
                record["norm_faults_a_streamed"] = planted_faults(
                    {"A streamed part unwritten": streamed_unwritten(
                        y, plan)}, want, "kernel A")
            print(f"A edge {list(shape)} {dn} act={act} affine={affine} "
                  f"({fmt_plan(plan)}): max|diff| {err:.3e}", flush=True)
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
            print(f"B edge {list(shape)} co={co} {dn}/{cn} ("
                  f"{kb.forward_entry(shape[-1], co, cd)}): max|diff| "
                  f"{err:.3e}", flush=True)
    for shape, co in EDGE_B_SM90:
        for in_dt in (torch.float32, torch.bfloat16):
            dn = str(in_dt).split(".")[1]
            x = torch.randn(shape, device="cuda", generator=gen).to(in_dt)
            wt = 0.1 * torch.randn((co, shape[-1], 3, 3), device="cuda",
                                   generator=gen)
            y = kb.conv3x3(x, wt)
            torch.cuda.synchronize()
            if y.dtype != in_dt:
                raise AssertionError(f"B sm90 edge: {y.dtype} out of {in_dt}")
            err = check_close(f"B sm90 edge {shape} co {co} {dn}", y,
                              kb.conv3x3_plain(x, wt), dn)
            print(f"B edge {list(shape)} co={co} {dn}/bfloat16 ("
                  f"{kb.forward_entry(shape[-1], co, torch.bfloat16)}): "
                  f"max|diff| {err:.3e}", flush=True)
    for (n, h, w), cin, co in EDGE_DX_SM90:
        for in_dt in (torch.float32, torch.bfloat16):
            dn = str(in_dt).split(".")[1]
            g = torch.randn((n, h, w, co), device="cuda", generator=gen).to(in_dt)
            wt = 0.1 * torch.randn((co, cin, 3, 3), device="cuda",
                                   generator=gen)
            dx = kb.dgrad_kernel(g, wt, torch.bfloat16)
            torch.cuda.synchronize()
            if dx.dtype != in_dt or dx.shape != (n, h, w, cin):
                raise AssertionError(f"B-dx sm90 edge: {dx.dtype} "
                                     f"{tuple(dx.shape)}")
            err = check_close(f"B-dx sm90 edge {(n, h, w)} cin {cin} co {co} "
                              f"{dn}", dx, kb.conv3x3_dgrad_plain(g, wt), dn)
            print(f"B-dx edge {[n, h, w]} dx co={cin} k={co} {dn}/bfloat16 ("
                  f"{kb.dgrad_entry(cin, co, torch.bfloat16)}, tiles of "
                  f"{kb.co_tile(cin)}): max|diff| {err:.3e}", flush=True)
    for (n, h, w), cin, co in EDGE_E_SM90:
        for in_dt in (torch.float32, torch.bfloat16):
            dn = str(in_dt).split(".")[1]
            x = torch.randn((n, h, w, cin), device="cuda", generator=gen).to(in_dt)
            k = 0.1 * torch.randn((3, 3, cin, co), device="cuda", generator=gen)
            want = kb.conv3x3_p1_plain(x, k)
            for fn in (kb.conv3x3_p1, kb.conv3x3_p1_h):
                y = fn(x, k)
                torch.cuda.synchronize()
                if y.dtype != torch.float32 or y.shape != (n, h, w, co):
                    raise AssertionError(f"E sm90 edge: {fn.__name__} gave "
                                         f"{y.dtype} {tuple(y.shape)}")
                err = check_close(f"E sm90 edge {(n, h, w, cin)} co {co} {dn} "
                                  f"{fn.__name__}", y, want, "float32")
            print(f"E edge {[n, h, w, cin]} co={co} {dn}/bfloat16 ("
                  f"{kb.p1_entry(cin, torch.bfloat16)}, tiles of "
                  f"{kb.co_tile(co)}): max|diff| {err:.3e}", flush=True)
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
            print(f"C edge {list(shape)} {dn} act={act} affine={affine} "
                  f"({fmt_plan(norm_plan(ka, shape, dt, 2))}): max|diff| "
                  f"{err:.3e}", flush=True)
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
    for shape, co in EDGE_D_SM90:
        for in_dt in (torch.float32, torch.bfloat16):
            dn = str(in_dt).split(".")[1]
            x = torch.randn(shape, device="cuda", generator=gen).to(in_dt)
            g = torch.randn(shape[:3] + (co,), device="cuda",
                            generator=gen).to(in_dt)
            dk = kd.conv3x3_wgrad(x, g)
            torch.cuda.synchronize()
            err = check_share(f"D sm90 edge {shape} co {co} {dn}", dk,
                              kd.conv3x3_wgrad_plain(x, g))
            if not torch.equal(dk, kd.conv3x3_wgrad(x, g)):
                raise AssertionError(f"D sm90 edge {shape} {dn}: two runs "
                                     "differ")
            print(f"D edge {list(shape)} co={co} {dn}/bfloat16 "
                  f"({kd.partial_entry(torch.bfloat16)}, plan "
                  f"{kd.launch_plan(*shape)}): max|diff| {err:.3e}",
                  flush=True)
    # Kernel E off B's domain; its output is float32 whatever the input.
    pairs = [(c, co) for c in E_CIN for co in E_CO] + [(96, 96)]
    for i, (c, co) in enumerate(pairs):
        n, h, w = E_NHW[i % len(E_NHW)]
        worst = 0.0
        for in_dt, cd in ((torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.bfloat16),
                          (torch.float32, torch.float32),
                          (torch.bfloat16, torch.float32)):
            dn, cn = str(in_dt).split(".")[1], str(cd).split(".")[1]
            x = torch.randn((n, h, w, c), device="cuda", generator=gen).to(in_dt)
            k = 0.1 * torch.randn((3, 3, c, co), device="cuda", generator=gen)
            want = kb.conv3x3_p1_plain(x, k, compute_dtype=cd)
            for fn in (kb.conv3x3_p1, kb.conv3x3_p1_h):
                y = fn(x, k, compute_dtype=cd)
                torch.cuda.synchronize()
                if y.dtype != torch.float32 or y.shape != (n, h, w, co):
                    raise AssertionError(f"E edge: {fn.__name__} gave "
                                         f"{y.dtype} {tuple(y.shape)}")
                worst = max(worst, check_close(
                    f"E edge {(n, h, w, c)} co {co} {dn}/{cn} {fn.__name__}",
                    y, want, "float32"))
        print(f"E edge {[n, h, w, c]} co={co} (f32/bf16 inputs, both compute "
              f"dtypes, both names): max|diff| {worst:.3e}", flush=True)


def phase_kernels(torch, ka, kb, seed, record, parent):
    """Kernel vs plain version at every serving shape; then times.
    ``parent``: the parent's rows by kernel (``load_baseline``)."""
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
                plan = norm_plan(ka, x.shape, dt, 1)
                if (batch, h, dn) == (TRAIN_BATCH, FULL_RES, "float32"):
                    y2, st2 = ka.forward_kernel(x, s, o, "relu", 0.2)
                    y3, st3 = ka.forward_kernel(x, s, o, "relu", 0.2)
                    if not (torch.equal(y, y2) and torch.equal(y2, y3)
                            and torch.equal(st2, st3)):
                        raise AssertionError(f"A {x.shape}: two runs differ")
                    print(f"A {list(x.shape)}: two runs equal", flush=True)
                if (batch, h, dn) == (TRAIN_BATCH, 16, "float32"):
                    record["norm_faults_a_partial"] = planted_faults(
                        {"A block 0's partial left out": partial_left_out(
                            torch, ka, x, None, None, s, o, "relu", plan)},
                        ref, "kernel A")
                nbytes = 2 * x.numel() * x.element_size()
                row = {"shape": [batch, h, w, c], "dtype": dn,
                       "per_forward": per_fwd, "max_abs_err": err,
                       "tol": TOL[dn], "plan": plan._asdict(),
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
                row["gbps"] = nbytes / row["ms"] / 1e6
                row["parent_ms"] = parent["kernel_a"].get(
                    (tuple(row["shape"]), dn))
                a_rows.append(row)
                print(f"A {row['shape']} {dn}: max|diff| {err:.3e} "
                      f"(atol {TOL[dn][0]}, rtol {TOL[dn][1]:.4g}) "
                      f"ms {row['ms']:.4f} ({row['gbps']:.0f} GB/s, call "
                      f"{row['call_ms']:.4f}) parent {fmt(row['parent_ms'])} "
                      f"plain {row['plain_ms']:.4f} library "
                      f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
                      f"({fmt_plan(plan)})", flush=True)
        # Kernel B: (input dtype, compute dtype); the serving path runs the
        # first (float32 activations, bf16 operands).
        combos = [(torch.float32, torch.bfloat16),
                  (torch.bfloat16, torch.bfloat16)]
        if batch == 1:
            combos += [(torch.float32, torch.float32)]
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
                row["parent_ms"] = parent["kernel_b"].get(
                    (tuple(row["shape"]), 64, dn, cn))
                row["entry"] = kb.forward_entry(cin, 64, cd)
                if (row["entry"] == kb.SM90_ENTRY and dn == "float32"
                        and "sm90_faults" not in record):
                    record["sm90_faults"] = plant_sm90_faults(
                        torch, kb, x, wt, ref)
                b_rows.append(row)
                print(f"B {row['shape']} {dn}/{cn} ({row['entry']}): "
                      f"max|diff| {err:.3e} "
                      f"(atol {TOL[dn][0]}, rtol {TOL[dn][1]:.4g}) "
                      f"ms {row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s, call "
                      f"{row['call_ms']:.4f}) parent {fmt(row['parent_ms'])} "
                      f"plain {row['plain_ms']:.4f} library "
                      f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f}",
                      flush=True)
    record["kernel_a"] = a_rows
    record["kernel_b"] = b_rows
    return a_rows, b_rows


def plant_sm90_faults(torch, kb, x, wt, ref):
    """Two faults planted on the wgmma kernel at one serving shape (float32
    input and output): its output x 1.01, and the output of an input whose
    second 16-channel slice is zero, as a body that skipped that slice would
    give. Each must fail the per-shape check against ``ref``, the plain
    version of the unchanged input; returns their max |diff|."""
    xs = x.clone()
    xs[..., 16:32] = 0
    planted = {"output x 1.01": kb.forward_kernel(x, wt, torch.bfloat16) * 1.01,
               "Cin slice 16-31 dropped": kb.forward_kernel(xs, wt,
                                                            torch.bfloat16)}
    return planted_faults(planted, ref, "the wgmma kernel")


def plant_dgrad_faults(torch, kb, g, wt, want):
    """Two faults planted on the wgmma body's dgrad entry at the widest
    training shape (dx Co 384, six Co tiles): dx x 1.01, and the last Co
    tile left unwritten (zero), as a block that stopped its tile walk one
    short would leave it. Each must fail the per-shape check against
    ``want``, the plain dx; returns their max |diff|."""
    dx = kb.dgrad_kernel(g, wt, torch.bfloat16)
    tile = kb.co_tile(dx.shape[-1])
    last = (dx.shape[-1] - 1) // tile * tile
    unwritten = dx.clone()
    unwritten[..., last:] = 0
    return planted_faults({"dx x 1.01": dx * 1.01,
                           "last Co tile unwritten": unwritten}, want,
                          "the wgmma dgrad entry")


def planted_faults(planted, want, where):
    """Each planted output must fail check_close (float32 tolerance)
    against ``want``; returns name -> max |diff|."""
    out = {}
    for name, y in planted.items():
        try:
            check_close(f"planted {name}", y, want, "float32")
        except AssertionError:
            out[name] = (y - want).abs().max().item()
            print(f"planted fault on {where}, {name}: caught, max|diff| "
                  f"{out[name]:.3e}", flush=True)
            continue
        raise AssertionError(f"planted fault {name} on {where} passed the "
                             "per-shape check")
    return out


def plant_wgrad_faults(torch, kd, x, g, want):
    """Three faults planted on the wgmma weight gradient at one training
    shape: dk x 1.0005; g's last 64-pixel row of one strip zeroed, as a
    kernel that skipped the last row step of a run would give; x shifted by
    one column, as a wrong dw offset would give. Each must fail check_share
    against ``want``, the plain version of the unchanged inputs; returns
    their max |diff| and the limit."""
    gz = g.clone()
    gz[-1, -1, -64:] = 0
    xs = torch.zeros_like(x)
    xs[:, :, 1:] = x[:, :, :-1]
    planted = {"dk x 1.0005": kd.conv3x3_wgrad(x, g) * 1.0005,
               "last row step of a strip dropped": kd.conv3x3_wgrad(x, gz),
               "x shifted one column": kd.conv3x3_wgrad(xs, g)}
    limit = SUM_SHARE * want.abs().max().item()
    out = {"limit": limit}
    for name, dk in planted.items():
        try:
            check_share(f"planted {name}", dk, want)
        except AssertionError:
            out[name] = (dk - want).abs().max().item()
            print(f"planted fault on the wgmma weight gradient, {name}: "
                  f"caught, max|diff| {out[name]:.3e} > limit {limit:.3e}",
                  flush=True)
            continue
        raise AssertionError(f"planted fault {name} on the wgmma weight "
                             "gradient passed the per-shape check")
    return out


# bf16 outputs (A, C's dx, B and B-dx on bf16 activations): the kernel and
# its plain version each round a float32 result to bf16, so an entry may
# differ by one bf16 step, 2^-7 of its value at most; BF16_ATOL_SHARE of
# the largest entry covers the entries that cancellation leaves near zero.
# Two faults planted on each kernel's output must fail the check: every
# entry x (1 + 2^-6), and only the entries under a quarter of the largest
# x (1 + 2^-4).
BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -7, 2.0 ** -9


def check_bf16(name, got, want):
    """A bf16 output against its plain version: each entry within
    BF16_RTOL of itself plus BF16_ATOL_SHARE of the largest |entry|.
    Returns (max |diff|, the largest diff's share of its limit)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    limit = BF16_RTOL * w.abs() + BF16_ATOL_SHARE * w.abs().max()
    share = (err / limit).max().item()
    if not (math.isfinite(share) and share <= 1):
        raise AssertionError(f"{name}: kernel and plain version disagree, "
                             f"max |diff| / limit {share:.3f} (rtol 2^-7, "
                             "atol 2^-9 of the largest entry)")
    return err.max().item(), share


def plant_bf16_faults(torch, where, got, want):
    """The two faults of check_bf16 on ``got``; each must fail it."""
    g, w = got.float(), want.float()
    small = w.abs() < w.abs().max() / 4
    out = {}
    for name, bad in (("x (1 + 2^-6)", g * (1 + 2.0 ** -6)),
                      ("entries under max/4 x (1 + 2^-4)",
                       torch.where(small, g * (1 + 2.0 ** -4), g))):
        try:
            check_bf16(f"planted {name}", bad, want)
        except AssertionError:
            out[name] = "caught"
            continue
        raise AssertionError(f"planted fault {name} on {where} passed the "
                             "bf16 check")
    print(f"planted faults on {where}: {out}", flush=True)
    return out


def phase_train_kernels(torch, ka, kb, kd, seed, record, parent):
    """Kernels A, C, B-dx and D against their plain versions at every shape
    of a training step (batch 4), float32 and bf16 activations (the second
    what --bf16_resident gives them), bf16 conv operands, with times; B's
    forward checked on both; then B's forward at the training shapes of
    nf 32 and 16 (Co 32 and 16). ``parent``: the parent's rows by kernel,
    printed beside the float32 rows."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    dev = "cuda"
    rows = {k: [] for k in ("c", "c_bf16", "a_bf16", "dx", "dx_bf16", "d",
                            "d_bf16")}
    faults = record.setdefault("bf16_faults", {})
    for ((h, w, c), per_step), dt in [(r, dt) for dt in (torch.float32,
                                                         torch.bfloat16)
                                      for r in A_SHAPES]:
        dn = str(dt).split(".")[1]
        bf16 = dt == torch.bfloat16
        shape = (TRAIN_BATCH, h, w, c)
        x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).to(dt)
        g = torch.randn(shape, device=dev, generator=gen).to(dt)
        s = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        o = 0.1 * torch.randn(c, device=dev, generator=gen)
        y, st = ka.forward_kernel(x, s, o, "relu", 0.2)
        got = ka.backward_kernel(x, g, st, s, o, "relu", 0.2)
        torch.cuda.synchronize()
        want = ka.instance_norm_act_backward_plain(x, g, st, s, o, act="relu")
        if bf16:
            # A's forward as the resident step runs it (bf16 in and out).
            want_y = ka.instance_norm_act_plain(x, s, o, act="relu")
            err_a, share_a = check_bf16(f"A {shape} bf16", y, want_y)
            err, share = check_bf16(f"C {shape} bf16", got[0], want[0])
            if y.dtype != dt or got[0].dtype != dt:
                raise AssertionError(f"A/C {shape} bf16: outputs "
                                     f"{y.dtype}, {got[0].dtype}")
            if h == FULL_RES:
                faults["A"] = plant_bf16_faults(torch, "kernel A (bf16)", y,
                                                want_y)
                faults["C"] = plant_bf16_faults(torch, "kernel C (bf16)",
                                                got[0], want[0])
        else:
            err = check_close(f"C {shape} {dn}", got[0], want[0], dn)
        for name, a, b in zip(("dscale", "doffset"), got[1:], want[1:]):
            check_share(f"C {shape} {dn} {name}", a, b)
        plan = norm_plan(ka, shape, dt, 2)
        if dn == "float32" and h == FULL_RES:
            again = ka.backward_kernel(x, g, st, s, o, "relu", 0.2)
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"C {shape}: two runs differ")
            print(f"C {list(shape)}: two runs equal", flush=True)
            record["norm_faults_c_streamed"] = planted_faults(
                {"C streamed part unwritten": streamed_unwritten(got[0],
                                                                 plan)},
                want[0], "kernel C")
        if dn == "float32" and h == 16:
            record["norm_faults_c_partial"] = planted_faults(
                {"C block 0's partial left out": partial_left_out(
                    torch, ka, x, g, st, s, o, "relu", plan)},
                want[0], "kernel C")
        nbytes = 3 * x.numel() * x.element_size()
        row = {"shape": list(shape), "dtype": dn,
               "per_step": per_step, "max_abs_err": err,
               "tol": "bf16 check" if bf16 else TOL[dn],
               "plan": plan._asdict(),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        if bf16:
            row["limit_share"] = share
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
        row["gbps"] = nbytes / row["ms"] / 1e6
        row["parent_ms"] = (parent["kernel_c"].get(tuple(row["shape"]))
                            if dn == "float32" else None)
        rows["c_bf16" if bf16 else "c"].append(row)
        print(f"C {row['shape']} {dn}: max|diff| {err:.3e} ms "
              f"{row['ms']:.4f} ({row['gbps']:.0f} GB/s) parent "
              f"{fmt(row['parent_ms'])} plain {row['plain_ms']:.4f} library "
              f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
              f"({fmt_plan(plan)})", flush=True)
        if bf16:
            a_bytes = 2 * x.numel() * x.element_size()
            a_row = {"shape": list(shape), "dtype": dn, "per_step": per_step,
                     "max_abs_err": err_a, "limit_share": share_a,
                     "bound_ms": a_bytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes"}
            a_row["ms"], _ = cuda_ms(
                lambda: ka.forward_kernel(x, s, o, "relu", 0.2))
            a_row["plain_ms"], _ = cuda_ms(
                lambda: ka.instance_norm_act_plain(x, s, o, act="relu"))
            xn = x.permute(0, 3, 1, 2)
            a_row["library_ms"], _ = cuda_ms(lambda: torch.relu(
                F.instance_norm(xn, weight=s, bias=o, eps=ka.EPS)))
            rows["a_bf16"].append(a_row)
            print(f"A train {a_row['shape']} bf16: max|diff| {err_a:.3e} "
                  f"({share_a:.3f} of its limit) ms {a_row['ms']:.4f} plain "
                  f"{a_row['plain_ms']:.4f} library "
                  f"{a_row['library_ms']:.4f} bound {a_row['bound_ms']:.4f}",
                  flush=True)
            print(f"C {row['shape']} bf16: {share:.3f} of its limit",
                  flush=True)

    cd = torch.bfloat16
    for cin, per_step in B_CINS:
        pix = TRAIN_BATCH * FULL_RES * FULL_RES
        x = torch.randn((TRAIN_BATCH, FULL_RES, FULL_RES, cin), device=dev,
                        generator=gen)
        g = torch.randn((TRAIN_BATCH, FULL_RES, FULL_RES, 64), device=dev,
                        generator=gen)
        wt = 0.05 * torch.randn((64, cin, 3, 3), device=dev, generator=gen)
        first = cin == B_CINS[0][0]
        # B's forward as the training step runs it: through the autograd
        # Function with grad enabled, float32 and bf16 activations.
        for xin in (x, x.to(cd)):
            dn = str(xin.dtype).split(".")[1]
            xg = xin.detach().requires_grad_()
            y = kb.conv3x3(xg, wt.detach().requires_grad_(), compute_dtype=cd)
            torch.cuda.synchronize()
            if y.grad_fn is None:
                raise AssertionError("B forward under grad gave no grad_fn")
            want = kb.conv3x3_plain(xin, wt, compute_dtype=cd)
            if xin.dtype == cd:
                err, share = check_bf16(f"B train cin {cin} bf16", y.detach(),
                                        want)
                if first:
                    faults["B"] = plant_bf16_faults(torch, "kernel B (bf16)",
                                                    y.detach(), want)
                note = f" ({share:.3f} of its limit)"
            else:
                err = check_close(f"B train cin {cin} {dn}", y.detach(), want,
                                  dn)
                note = ""
            print(f"B train fwd cin {cin} {dn} "
                  f"({kb.forward_entry(cin, 64, cd)}): max|diff| {err:.3e}"
                  f"{note}", flush=True)
            del y, xg, want
        flops = 2 * pix * 9 * cin * 64
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        xl = x.to(cd).permute(0, 3, 1, 2)
        gl = g.to(cd).permute(0, 3, 1, 2)
        wl = wt.to(cd)
        for dt in (torch.float32, cd):
            dn = str(dt).split(".")[1]
            bf16 = dt == cd
            xs, gs = x.to(dt), g.to(dt)
            dx = kb.dgrad_kernel(gs, wt, cd)
            dk = kd.conv3x3_wgrad(xs, gs, compute_dtype=cd)
            torch.cuda.synchronize()
            want_dx = kb.conv3x3_dgrad_plain(gs, wt, compute_dtype=cd)
            if dx.dtype != dt:
                raise AssertionError(f"B-dx cin {cin} {dn}: dx {dx.dtype}")
            note = {}
            if bf16:
                err_dx, note["B-dx"] = check_bf16(f"B-dx cin {cin} bf16", dx,
                                                  want_dx)
                if first:
                    faults["B-dx"] = plant_bf16_faults(
                        torch, "kernel B-dx (bf16)", dx, want_dx)
            else:
                err_dx = check_close(f"B-dx cin {cin}", dx, want_dx, dn)
                if cin == B_CINS[-1][0]:
                    record["dgrad_faults"] = plant_dgrad_faults(
                        torch, kb, gs, wt, want_dx)
            del dx, want_dx
            want_d = kd.conv3x3_wgrad_plain(xs, gs, compute_dtype=cd)
            err_d = check_share(f"D cin {cin} {dn}", dk, want_d)
            dk2 = kd.conv3x3_wgrad(xs, gs, compute_dtype=cd)
            if not torch.equal(dk, dk2):
                raise AssertionError(f"D cin {cin} {dn}: two runs differ")
            if cin == 64 and not bf16:
                record["wgrad_faults"] = plant_wgrad_faults(torch, kd, xs, gs,
                                                            want_d)
            if first and bf16:
                try:
                    check_share("planted dk x (1 + 2^-10)",
                                dk * (1 + 2.0 ** -10), want_d)
                except AssertionError:
                    faults["D"] = {"dk x (1 + 2^-10)": "caught"}
                    print(f"planted faults on kernel D (bf16): {faults['D']}",
                          flush=True)
                else:
                    raise AssertionError("planted fault on kernel D (bf16) "
                                         "passed the per-shape check")
            del dk, dk2, want_d
            es = xs.element_size()
            for key, name, err, nbytes, fn, plain, lib in (
                    ("dx", "B-dx", err_dx,
                     (g.numel() + x.numel()) * es + 9 * cin * 64 * 2,
                     lambda: kb.dgrad_kernel(gs, wt, cd),
                     lambda: kb.conv3x3_dgrad_plain(gs, wt, compute_dtype=cd),
                     lambda: torch.nn.grad.conv2d_input(xl.shape, wl, gl,
                                                        padding=1)),
                    ("d", "D", err_d,
                     (g.numel() + x.numel()) * es + 9 * cin * 64 * 4,
                     lambda: kd.conv3x3_wgrad(xs, gs, compute_dtype=cd),
                     lambda: kd.conv3x3_wgrad_plain(xs, gs, compute_dtype=cd),
                     lambda: torch.nn.grad.conv2d_weight(xl, wl.shape, gl,
                                                         padding=1))):
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                row = {"shape": [TRAIN_BATCH, FULL_RES, FULL_RES, cin],
                       "co": 64, "dtype": dn, "compute": "bfloat16",
                       "per_step": per_step, "max_abs_err": err,
                       "flops": flops, "bound_ms": max(t_ops, t_bytes),
                       "bound_by": ("operations" if t_ops >= t_bytes
                                    else "bytes")}
                if name in note:
                    row["limit_share"] = note[name]
                row["ms"], row["call_ms"] = cuda_ms(fn)
                row["plain_ms"], _ = cuda_ms(plain)
                row["library_ms"], _ = cuda_ms(lib)
                row["tflops"] = flops / row["ms"] / 1e9
                row["gbps"] = nbytes / row["ms"] / 1e6
                row["parent_ms"] = None if bf16 else parent[
                    "kernel_b_dx" if name == "B-dx" else "kernel_d"].get(
                        tuple(row["shape"]))
                rows[key + "_bf16" if bf16 else key].append(row)
                print(f"{name} cin {cin} {dn}: max|diff| {err:.3e}"
                      + (f" ({note[name]:.3f} of its limit)"
                         if name in note else "")
                      + f" ms {row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s, "
                      f"{row['gbps']:.0f} GB/s) parent "
                      f"{fmt(row['parent_ms'])} plain {row['plain_ms']:.4f} "
                      f"library {row['library_ms']:.4f} bound "
                      f"{row['bound_ms']:.4f} ({row['bound_by']})",
                      flush=True)
    record["kernel_c"], record["kernel_b_dx"], record["kernel_d"] = (
        rows["c"], rows["dx"], rows["d"])
    for key in ("a", "c", "dx", "d"):
        record[f"kernel_{'b_dx' if key == 'dx' else key}_bf16"] = \
            rows[key + "_bf16"]
    record["kernel_b_narrow"] = narrow_b_rows(torch, kb, gen)
    return rows


# B's forward at the training shapes of nf 32 and 16, (Cin, launches a
# step): the wgmma body at Co 32 and 16.
B_CINS_NARROW = {32: [(32, 5), (96, 1), (128, 1), (160, 1), (192, 1)],
                 16: [(16, 5), (48, 1), (64, 1), (80, 1), (96, 1)]}


def narrow_b_rows(torch, kb, gen):
    """B's forward against its plain version at batch 4, 256x256, float32
    activations, bf16 operands, Co 32 and 16 (UNet++ nf 32 and 16), with
    times; the sum of each width's step is printed."""
    cd = torch.bfloat16
    rows = []
    for co, cins in B_CINS_NARROW.items():
        for cin, per_step in cins:
            x = torch.randn((TRAIN_BATCH, FULL_RES, FULL_RES, cin),
                            device="cuda", generator=gen)
            wt = 0.05 * torch.randn((co, cin, 3, 3), device="cuda",
                                    generator=gen)
            y = kb.conv3x3(x, wt)
            torch.cuda.synchronize()
            err = check_close(f"B cin {cin} co {co}", y, kb.conv3x3_plain(
                x, wt), "float32")
            flops = 2 * x.numel() // cin * 9 * cin * co
            nbytes = (x.numel() + y.numel()) * 4 + 9 * cin * co * 2
            t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            row = {"shape": list(x.shape), "co": co, "dtype": "float32",
                   "compute": "bfloat16", "per_step": per_step,
                   "max_abs_err": err, "flops": flops,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "entry": kb.forward_entry(cin, co, cd)}
            row["ms"], row["call_ms"] = cuda_ms(lambda: kb.conv3x3(x, wt))
            row["plain_ms"], _ = cuda_ms(lambda: kb.conv3x3_plain(x, wt))
            xl, wl = x.to(cd).permute(0, 3, 1, 2), wt.to(cd)
            row["library_ms"], _ = cuda_ms(
                lambda: torch.nn.functional.conv2d(xl, wl, padding=1))
            row["tflops"] = flops / row["ms"] / 1e9
            rows.append(row)
            print(f"B cin {cin} co {co} ({row['entry']}): max|diff| {err:.3e} "
                  f"ms {row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s) plain "
                  f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} "
                  f"bound {row['bound_ms']:.4f} ({row['bound_by']})",
                  flush=True)
        step = {k: sum(r[k] * r["per_step"] for r in rows if r["co"] == co)
                for k in ("ms", "library_ms", "bound_ms")}
        print(f"B forward a training step at nf {co} (Co {co}): "
              f"{step['ms']:.4f} ms (cuDNN {step['library_ms']:.4f}, bound "
              f"{step['bound_ms']:.4f})", flush=True)
    return rows


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
            "conv3x3_wgrad": kd.conv3x3_wgrad.launches,
            "conv3x3_p1": kb.conv3x3_p1.launches,
            "conv3x3_p1_h": kb.conv3x3_p1_h.launches}


def reset_counts(ka, kb, kd):
    ka.instance_norm_act.launches = ka.backward_kernel.launches = 0
    kb.conv3x3.launches = kb.dgrad_kernel.launches = 0
    kd.conv3x3_wgrad.launches = 0
    kb.conv3x3_p1.launches = kb.conv3x3_p1_h.launches = 0
    kb.conv3x3.flops = kb.dgrad_kernel.flops = kd.conv3x3_wgrad.flops = 0
    for fn in (ka.instance_norm_act, ka.backward_kernel, kb.conv3x3,
               kb.dgrad_kernel, kd.conv3x3_wgrad):
        fn.bf16_launches = 0


def train_run(torch, ka, kb, kd, root, folder, args, extra=(),
              graphed=True):
    """cli.train at its defaults on root/data for 2 epochs on cuda (the
    library convs with cuDNN's TF32 default, as a user runs them), the
    launch counters set to 0 just before and read just after: (trainer,
    launches, seconds, peak device memory)."""
    from tactile_gan_torch.cli import train as train_cli

    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ka, kb, kd)
    t0 = time.perf_counter()
    trainer = train_cli.main(["--data", os.path.join(root, "data"),
                              "--total_epochs", "2", "--epoch_constant", "1",
                              "--folder_save", folder, "--seed",
                              str(args.seed), *extra], graphed=graphed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts(ka, kb, kd)
    torch.backends.cudnn.allow_tf32 = False
    return trainer, counts, seconds, torch.cuda.max_memory_allocated()


def run_summary(trainer, counts, seconds, peak, per=None):
    """The numbers of one training run; the launch counts checked against
    ``per`` a step (by default the generator's, ``per_step``)."""
    cfg, steps = trainer.cfg, trainer.state.step
    want = {k: v * steps for k, v in (per or per_step(cfg.gen)).items()}
    if counts != want:
        raise AssertionError(f"{cfg.folder_save}: training launches "
                             f"{counts}, expected {want} ({steps} steps)")
    losses = {k: getattr(trainer, f"{k}_loss") for k in (
        "gen", "disc", "l1", "gp", "per")}
    if not all(len(v) == 2 and all(math.isfinite(x) for x in v)
               for v in losses.values()):
        raise AssertionError(f"{cfg.folder_save}: training losses {losses}")
    ms = trainer.epoch_seconds[1] * 1e3 / trainer.steps_per_epoch
    graphs = ({str(gp): c.capture_s for gp, c in
               sorted(trainer.graphed.captured.items())}
              if trainer.graphed is not None else None)
    return {"steps": steps, "steps_per_epoch": trainer.steps_per_epoch,
            "train_s": seconds, "epoch_seconds": trainer.epoch_seconds,
            "ms_per_step": ms, "img_per_s": TRAIN_BATCH * 1e3 / ms,
            "peak_mem_bytes": peak, "launches": counts, "losses": losses,
            "capture_s": graphs}


def print_run(label, r):
    graphs = ("eager step" if r["capture_s"] is None else "captured "
              + ", ".join(f"GP {gp}: {s:.2f} s" for gp, s in
                          r["capture_s"].items()))
    print(f"train ({label}): {r['steps']} steps in {r['train_s']:.2f} s "
          f"(epochs {r['epoch_seconds'][0]:.2f} s, "
          f"{r['epoch_seconds'][1]:.2f} s); epoch 2: {r['ms_per_step']:.2f} "
          f"ms/step = {r['img_per_s']:.2f} img/s at batch {TRAIN_BATCH}; "
          f"peak memory {r['peak_mem_bytes'] / 2**30:.2f} GiB; {graphs}; "
          f"launches {r['launches']}; losses {r['losses']}", flush=True)


def phase_train(torch, ka, kb, kd, args, record):
    """train.py at its defaults through the port's CLI on cuda: the step
    replays its CUDA graph, with periodic checkpoints; again at --reg_every
    2 (both GP variants captured in one trainer) and through the eager step
    (the test hook); then the trained folder through evaluate_folder, in the
    same process."""
    from tactile_gan_torch.eval import runner
    from tactile_gan_torch.utils.checkpoint import load_checkpoint

    out = {"pairs": TRAIN_PAIRS, "epochs": 2}
    with tempfile.TemporaryDirectory() as root:
        write_pairs(root, "train", chart_pairs(TRAIN_PAIRS, FULL_RES,
                                               args.seed + 5))
        write_pairs(root, "test", chart_pairs(8, FULL_RES, args.seed + 6))
        trainer, counts, seconds, peak = train_run(
            torch, ka, kb, kd, root, "train_smoke", args,
            ("--checkpoint_interval", "1"))
        cfg = trainer.cfg
        if (cfg.gen, cfg.nf, cfg.batch_size, cfg.image_size) != (
                "UNet++", 64, TRAIN_BATCH, FULL_RES) or not trainer.vgg_random_fallback:
            raise AssertionError(f"not the default training config: {cfg}")
        graphed = run_summary(trainer, counts, seconds, peak)
        if sorted(trainer.graphed.captured) != [True]:
            raise AssertionError(f"captured GP variants "
                                 f"{sorted(trainer.graphed.captured)}, "
                                 "expected [True] at --reg_every 1")
        out.update(graphed)
        out["config"] = {k: getattr(cfg, k) for k in (
            "gen", "nf", "batch_size", "image_size", "loss", "lambda_gp",
            "lambda_per", "version", "compute_dtype", "host_aug",
            "checkpoint_interval")}
        model_dir = cfg.models_dir()
        if not (min(graphed["losses"]["gp"]) > 0
                and min(graphed["losses"]["per"]) > 0):
            raise AssertionError(f"GP or perceptual term missing: "
                                 f"{graphed['losses']}")
        for name in ("final_model.pth", "params.txt"):
            if not os.path.exists(os.path.join(model_dir, name)):
                raise AssertionError(f"{name} not written")
        checkpoints = {}
        for epoch in (1, 2):
            path = os.path.join(trainer.checkpoints_dir(),
                                f"model_{epoch}.pth")
            ckpt = load_checkpoint(path)
            checkpoints[epoch] = ckpt["step"]
            if ckpt["step"] != epoch * trainer.steps_per_epoch or set(
                    ckpt["gen"]) != set(trainer.gen.state_dict()):
                raise AssertionError(f"{path}: step {ckpt['step']}, "
                                     f"{len(ckpt['gen'])} generator tensors")
        out["checkpoint_steps"] = checkpoints
        print_run("graphed, --checkpoint_interval 1", graphed)
        print(f"checkpoints read back: model_1.pth at step {checkpoints[1]}, "
              f"model_2.pth at step {checkpoints[2]}", flush=True)

        trainer2, *run = train_run(torch, ka, kb, kd, root, "train_gp2",
                                   args, ("--reg_every", "2"))
        out["reg_every_2"] = run_summary(trainer2, *run)
        if sorted(trainer2.graphed.captured) != [False, True]:
            raise AssertionError(f"--reg_every 2 captured the GP variants "
                                 f"{sorted(trainer2.graphed.captured)}")
        print_run("graphed, --reg_every 2", out["reg_every_2"])
        del trainer2

        trainer3, *run = train_run(torch, ka, kb, kd, root, "train_eager",
                                   args, graphed=False)
        out["eager"] = run_summary(trainer3, *run)
        print_run("eager step", out["eager"])
        del trainer3

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


# UNet++ widths beside the default: row 0 on B's tail instantiation (8, 12,
# 24; 12 also pads A, C and D), on the wgmma body at Co 32 (32) and on the
# library conv (128).
NF_OTHER = (8, 12, 24, 32, 128)
NF_TRACED = 32
NF_SIZE, NF_BATCH = 64, 2


def phase_nf(torch, ka, kb, kd, args, record):
    """cli.train and cli.test at nf 8, 12, 24, 32 and 128 on the card: one
    epoch of two steps at 64x64, batch 2, with --debug_nans; the trained
    generator's forward on the card against the CPU's. At nf <= 64 the
    launch counts are the default width's per step and per forward; at nf
    128 the row-0 convs take the library conv: no B, B-dx or D launch."""
    from tactile_gan_torch.cli import test as test_cli
    from tactile_gan_torch.cli import train as train_cli
    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.eval import runner

    out = []
    for nf in NF_OTHER:
        with tempfile.TemporaryDirectory() as root:
            write_pairs(root, "train", chart_pairs(2 * NF_BATCH, NF_SIZE,
                                                   args.seed + 20 + nf))
            write_pairs(root, "test", chart_pairs(NF_BATCH, NF_SIZE,
                                                  args.seed + 21 + nf))
            # One width also traces its epoch (an eager step, the capture
            # and a replay) under --profile_dir.
            prof = os.path.join(root, "profile")
            traced = ["--profile_dir", prof] if nf == NF_TRACED else []
            reset_counts(ka, kb, kd)
            trainer = train_cli.main([
                "--data", os.path.join(root, "data"), "--nf", str(nf),
                "--image_size", str(NF_SIZE), "--batch_size", str(NF_BATCH),
                "--total_epochs", "1", "--epoch_constant", "1",
                "--folder_save", f"nf{nf}", "--seed", str(args.seed),
                "--debug_nans", *traced])
            if traced and not any(f.endswith(".pt.trace.json") for _, _, fs
                                  in os.walk(prof) for f in fs):
                raise AssertionError(f"nf {nf}: --profile_dir wrote no trace")
            metrics = test_cli.main(["--folder", f"nf{nf}", "--work_root",
                                     root, "--eval_batch", str(NF_BATCH)])
            torch.cuda.synchronize()
            counts = launch_counts(ka, kb, kd)
            losses = {k: getattr(trainer, f"{k}_loss") for k in (
                "gen", "disc", "l1", "gp", "per")}
            cfg = TrainConfig.from_params_file(os.path.join(
                trainer.cfg.models_dir(), "params.txt"))
            ckpt = os.path.join(trainer.cfg.models_dir(), "final_model.pth")
            x = torch.from_numpy(chart_pairs(1, NF_SIZE, args.seed)[0][0][None])
            f_gpu, _ = runner.load_model(ckpt, cfg, device="cuda")
            f_cpu, _ = runner.load_model(ckpt, cfg, device="cpu")
            got = f_gpu(runner.normalize_u8(x.cuda())).cpu()
            want = f_cpu(runner.normalize_u8(x))
            d = (got - want).abs()
            max_tol, mean_tol = SERVE_TOL[cfg.compute_dtype]
            res = {"nf": nf, "steps": trainer.state.step, "losses": losses,
                   "launches": counts, "metrics": metrics,
                   "max_abs": d.max().item(), "mean_abs": d.mean().item(),
                   "tol": [max_tol, mean_tol],
                   "kernel_convs": [list(getattr(trainer.gen, f"conv0_{c}")
                                         .kernel_convs) for c in range(5)]}
            out.append(res)
            print(f"nf {nf}: {res['steps']} steps, losses {losses}; served "
                  f"{metrics}; card vs CPU max|diff| {res['max_abs']:.3e} "
                  f"(tol {max_tol}), mean {res['mean_abs']:.3e} (tol "
                  f"{mean_tol}); launches {counts}", flush=True)
            steps = trainer.state.step
            forwards = 1  # NF_BATCH test pairs at eval_batch NF_BATCH
            per_step = dict(PER_STEP)
            if nf > kb.MAX_CO:
                for k in ("conv3x3", "conv3x3_dgrad", "conv3x3_wgrad"):
                    per_step[k] = 0
            want = {k: v * steps for k, v in per_step.items()}
            want["instance_norm_act"] += A_PER_FORWARD * forwards
            want["conv3x3"] += per_step["conv3x3"] * forwards
            if counts != want or steps != 2:
                raise AssertionError(f"nf {nf}: launches {counts}, expected "
                                     f"{want} ({steps} steps, {forwards} "
                                     "forward)")
            if not all(math.isfinite(v) for vs in losses.values() for v in vs):
                raise AssertionError(f"nf {nf}: losses {losses}")
            if not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"nf {nf}: metrics {metrics}")
            if got.shape != (1, NF_SIZE, NF_SIZE, 3) or not (
                    res["max_abs"] <= max_tol and res["mean_abs"] <= mean_tol):
                raise AssertionError(f"nf {nf}: card and CPU disagree: {res}")
    record["other_widths"] = out
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


STEP_NF, STEP_SIZE, STEP_BATCH = 16, 64, 2


def step_grads(torch, args, cfg, dev, eps=0.0, perturb_seed=0):
    """(losses, {"G"|"D": {name: grad}}) of one step of ``cfg`` (nf 16,
    64x64, batch 2) on dev from seeded weights, a seeded uint8 batch and
    injected draws, every weight scaled by (1 + eps N(0, 1)) when eps is
    given. Learning rate 0: both sides score G against the same D (Adam's
    first update is about lr * sign(grad), which would turn rounding noise
    in near-zero D gradients into 2 lr weight differences)."""
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import networks
    from tactile_gan_torch.models.vgg import load_vgg_features
    from tactile_gan_torch.train.state import TrainState, make_optimizer
    from tactile_gan_torch.train.step import build_train_step

    batch, size = STEP_BATCH, STEP_SIZE
    rng = np.random.default_rng(args.seed + 11)
    src, tgt = (torch.from_numpy(rng.integers(
        0, 255, (batch, size, size, 3), dtype=np.uint8)) for _ in range(2))
    noise = torch.from_numpy(rng.standard_normal((batch, 9, 9, 1))
                             .astype(np.float32))
    alpha = torch.from_numpy(rng.uniform(size=(batch, 1, 1, 1))
                             .astype(np.float32))
    gen, disc = networks(cfg)
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
    step = build_train_step(cfg, lambda _step: 0.0,
                            load_vgg_features(device=dev))
    losses = step(TrainState(gen, disc, opt_g, opt_d), src.to(dev),
                  tgt.to(dev), apply_gp=True, label_noise=noise.to(dev),
                  gp_alpha=alpha.to(dev)).cpu()
    return losses, grads


def faulty_runs(faults, run):
    """{"fault NAME": run()} with each fault of ``faults`` (``step_faults``)
    planted in turn."""
    runs = {}
    for name, (module, attr, faulty) in faults.items():
        orig = getattr(module, attr)
        # the wrappers count on their module's name
        faulty.launches = faulty.bf16_launches = faulty.flops = 0
        setattr(module, attr, faulty)
        try:
            runs[f"fault {name}"] = run()
        finally:
            setattr(module, attr, orig)
    return runs


def phase_step_card_vs_cpu(torch, ka, kb, args, record):
    """One training step on the card and on the CPU from the same weights
    and injected draws: nf=16, 64x64, batch 2, float32 compute, TF32 off,
    learning rate 0. Compares the losses and every gradient before the Adam
    update, beside the float32 floor and the planted faults."""
    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.train.step import METRICS

    cfg = TrainConfig(nf=STEP_NF, batch_size=STEP_BATCH,
                      image_size=STEP_SIZE, compute_dtype="float32")
    cpu = step_grads(torch, args, cfg, "cpu")

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

    runs = {"card": reading(step_grads(torch, args, cfg, "cuda"))}
    for s in STEP_FLOOR_SEEDS:
        runs[f"floor seed {s}"] = reading(step_grads(
            torch, args, cfg, "cpu", STEP_FLOOR_EPS, s))
    runs.update(faulty_runs(step_faults(ka, kb), lambda: reading(
        step_grads(torch, args, cfg, "cuda"))))
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


# Graphed against eager training (phase 8): GVE_STEPS steps at the
# defaults from one initial state, batch sequence and generator seed, the
# learning rate x0.8 from the third step on. Two statistics, each against
# the first eager run: the largest relative difference of any step's five
# losses, and the mean |difference| of every parameter after the last step
# in units of the base learning rate (an Adam step moves a weight by about
# one). The limit of each is GVE_FACTOR times the floor (a second eager run
# against the first: cuDNN's backward and the bilinear resize's backward
# sum in no fixed order), and never below GVE_MIN.
GVE_STEPS = 4
GVE_MILESTONE = 2
GVE_FACTOR = 10.0
GVE_MIN = {"loss_rel": 1e-5, "param_mean_lr": 1e-4}


def gve_inputs(torch, args, cfg):
    """The graph-vs-eager runs' batches (GVE_STEPS of chart pairs on the
    card), the seeded VGG fallback tower and the schedule (the rate x0.8
    from step GVE_MILESTONE)."""
    from tactile_gan_torch.models.vgg import load_vgg_features

    dev = torch.device("cuda")
    pairs = chart_pairs(GVE_STEPS * TRAIN_BATCH, FULL_RES, args.seed + 30)
    batches = [tuple(torch.from_numpy(np.stack([p[k] for p in pairs[
        i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]])).to(dev) for k in (0, 1))
        for i in range(GVE_STEPS)]

    def schedule(step):
        return cfg.lr * (0.8 if step >= GVE_MILESTONE else 1.0)

    return batches, load_vgg_features(device=dev), schedule


def gve_run(torch, args, cfg, batches, vgg, schedule, graphed,
            exclude=(), watch=()):
    """Training steps at ``cfg`` over ``batches`` from the seeded initial
    state (``args.seed``), eager or graphed (train/graph.py): (each step's
    losses, every parameter after the last step flattened, generator's then
    discriminator's, leaving out the generator parameters named in
    ``exclude``, {bias: its largest gradient ratio} of ``watch``).
    ``watch`` holds (bias, weight) names of generator parameters: at every
    step a hook on G's Adam takes max|grad bias| / max|grad weight| (in a
    graphed run the eager first step and the last replay)."""
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import networks
    from tactile_gan_torch.train.graph import GraphedStep
    from tactile_gan_torch.train.state import TrainState, make_optimizer
    from tactile_gan_torch.train.step import build_train_step

    dev = torch.device("cuda")
    gen, disc = networks(cfg)
    init_weights(gen, torch.Generator().manual_seed(args.seed + 31))
    init_weights(disc, torch.Generator().manual_seed(args.seed + 32))
    gen.to(dev)
    disc.to(dev)
    state = TrainState(gen, disc,
                       make_optimizer(gen.parameters(), cfg.lr, cfg.beta1),
                       make_optimizer(disc.parameters(), cfg.lr,
                                      cfg.beta1))
    named = dict(gen.named_parameters())
    ratios = []
    if watch:
        def hook(_opt, _args, _kwargs):
            ratios.append(torch.stack([
                named[b].grad.abs().max() / named[w].grad.abs().max()
                for b, w in watch]))
        state.opt_g.register_step_pre_hook(hook)
    step = build_train_step(cfg, schedule, vgg)
    rng = torch.Generator(device=dev).manual_seed(args.seed + 33)
    graph = GraphedStep(step, state, rng) if graphed else None
    losses = []
    for src, tgt in batches:
        losses.append(graph(src, tgt, apply_gp=True) if graphed else
                      step(state, src, tgt, apply_gp=True, generator=rng))
    params = torch.cat(
        [p.detach().flatten() for n, p in gen.named_parameters()
         if n not in exclude] + [p.detach().flatten()
                                 for p in disc.parameters()])
    worst = torch.stack(ratios).amax(0).tolist() if ratios else []
    out = (torch.stack(losses).cpu(), params,
           {b: r for (b, _), r in zip(watch, worst)})
    del graph, state, gen, disc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def graph_faults(torch, kb):
    """The faults planted on the graphed step: name -> (object, attribute,
    faulty replacement)."""
    from tactile_gan_torch.train import step as step_module

    orig = kb._kernel_weight
    kept = []

    def stale_relayout(weight, compute_dtype, use="forward"):
        # The capture reads the relayout cached by the eager step before it
        # (as a cache keyed without the weight's version would): every
        # replay convolves with the weights of that step.
        if kb._capturing(weight):
            hit = kb._relaid.get(weight, {}).get((compute_dtype, use))
            if hit is not None:
                kept.append(hit[1])
                return hit[1]
        return orig(weight, compute_dtype, use)

    def assigned_lr(opt, lr):
        for group in opt.param_groups:
            group["lr"] = torch.tensor(lr, dtype=torch.float32,
                                       device=group["params"][0].device)

    return {"relayout cached across the capture": (kb, "_kernel_weight",
                                                    stale_relayout),
            "lr assigned, not filled": (step_module, "set_lr", assigned_lr),
            "generator not registered": (
                torch.cuda.CUDAGraph, "register_generator_state",
                lambda self, generator: None)}


def phase_graph_vs_eager(torch, ka, kb, args, record):
    """GVE_STEPS training steps at train.py's defaults (UNet++ nf 64, batch
    4, 256x256, GP, v1 perceptual loss on the seeded VGG fallback), eager
    (twice: the floor) and graphed (train/graph.py) from one state, batch
    sequence and generator seed, beside three planted faults. A gate."""
    from tactile_gan_torch.core.config import TrainConfig

    cfg = TrainConfig()
    batches, vgg, schedule = gve_inputs(torch, args, cfg)

    def run(graphed):
        return gve_run(torch, args, cfg, batches, vgg, schedule, graphed)[:2]

    torch.backends.cudnn.allow_tf32 = True
    try:
        eager = run(False)

        def reading(res):
            (la, pa), (lb, pb) = res, eager
            return {"loss_rel": ((la - lb).abs() / lb.abs().clamp_min(1e-30))
                    .max().item(),
                    "param_mean_lr": ((pa - pb).abs().mean() / cfg.lr).item()}

        floor = reading(run(False))
        limits = {k: max(GVE_FACTOR * floor[k], GVE_MIN[k]) for k in floor}
        runs = {"graphed": reading(run(True))}
        for name, (owner, attr, faulty) in graph_faults(torch, kb).items():
            orig = getattr(owner, attr)
            setattr(owner, attr, faulty)
            try:
                runs[f"fault {name}"] = reading(run(True))
            except Exception as e:  # noqa: BLE001 -- a refusal is a catch
                runs[f"fault {name}"] = {"raised": f"{type(e).__name__}: "
                                         f"{str(e).strip()[:200]}"}
            finally:
                setattr(owner, attr, orig)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    print(f"graph vs eager, {GVE_STEPS} steps at the defaults: floor (eager "
          f"vs eager) {floor}; limits {limits}", flush=True)
    for name, r in runs.items():
        r["within_limits"] = "raised" not in r and all(
            r[k] <= limits[k] for k in limits)
        print(f"graph vs eager, {name}: {r}", flush=True)
    out = {"steps": GVE_STEPS, "milestone": GVE_MILESTONE, "floor": floor,
           "limits": limits, "factor": GVE_FACTOR, "min": GVE_MIN,
           "runs": runs}
    record["graph_vs_eager"] = out
    missed = [n for n, r in runs.items() if n.startswith("fault")
              and r["within_limits"]]
    if not runs["graphed"]["within_limits"] or missed:
        raise AssertionError(f"graph vs eager: graphed {runs['graphed']}, "
                             f"limits {limits}; planted faults not caught "
                             f"{missed}")
    return out


# The bf16-resident training step (phase resident): train.py's defaults
# with --bf16_resident --disc_bf16 beside the default (float32-resident)
# step, in one call. RESIDENT_STEPS graphed steps (the first eager, then
# the capture and its replays) give the launch counts; the profile runs
# RESIDENT_REPS more; RESIDENT_BIT_STEPS graphed steps are held to as many
# eager ones bit for bit (cuDNN deterministic).
RESIDENT = dict(bf16_resident=True, disc_bf16=True)
RESIDENT_STEPS = 4
RESIDENT_REPS = 3
RESIDENT_BIT_STEPS = 3
# Card against CPU, resident (nf 16, 64x64, batch 2, bf16 compute, lr 0).
# Tensor by tensor the resident step's gradients are noise: on the CPU a
# weight change of 1e-3 moves the median tensor by 0.43 of its largest entry.
# So the step is read over whole networks, where that noise averages out:
# the gradient's angle (1 - cos) and scale (|norm ratio - 1|) for G, for D,
# and the scale for the nine row-0 convs of kernels B and D (their angle
# reads 0.12-0.13 at the floor: 3x that comes near half of what an
# unrelated gradient reads), and the losses' largest relative difference.
# Each limit is RESIDENT_FACTOR times the largest of its floor runs, the
# CPU step with every weight x (1 + RESIDENT_EPS N(0, 1)) under five seeds
# (at most loss 0.016, G 0.0095 / 5.5e-4, D 0.0084 / 0.0023, row-0 scale
# 0.045 on the H100 machine's CPU), and must stay under half of what an
# unrelated or zero gradient reads (1). RESIDENT_EPS is a quarter of
# bf16's relative step (2^-8): about a quarter of the weights round to
# their neighbour, the size of the bf16 roundings in which cuDNN and the
# CPU library differ.
RESIDENT_EPS = 1e-3
RESIDENT_FACTOR = 3.0
RESIDENT_FLOOR_SEEDS = (14, 15, 16, 17, 18)
# Never below 1% for an angle or a scale: a norm ratio's distance from 1
# reads 4e-5 to 6e-4 over the floor's seeds (a signed change near zero by
# chance), under the card's own 1e-3. The planted faults read 0.10-2.5 in
# the statistics that catch them.
RESIDENT_MIN = 0.01
RESIDENT_STATS = ("loss_rel_err", "G angle", "G scale", "D angle",
                  "D scale", "row0 scale")


def bf16_counts(ka, kb, kd):
    """The bf16 launches of the five wrappers of the step (by
    ``launch_counts``'s names)."""
    return {"instance_norm_act": ka.instance_norm_act.bf16_launches,
            "instance_norm_act_backward": ka.backward_kernel.bf16_launches,
            "conv3x3": kb.conv3x3.bf16_launches,
            "conv3x3_dgrad": kb.dgrad_kernel.bf16_launches,
            "conv3x3_wgrad": kd.conv3x3_wgrad.bf16_launches}


def resident_faults(ka, kb):
    """The faults planted on the resident step's check: C's dx x 1.1, B-dx
    x 1.25 and D's dk x 1.25."""
    c_orig, dx_orig, d_orig = ka.backward_kernel, kb.dgrad_kernel, \
        kb.conv3x3_wgrad

    def c_dx_scaled(*a):
        dx, dscale, doffset = c_orig(*a)
        return dx * 1.1, dscale, doffset

    return {"C dx x 1.1": (ka, "backward_kernel", c_dx_scaled),
            "B-dx x 1.25": (kb, "dgrad_kernel",
                            lambda *a: dx_orig(*a) * 1.25),
            "D dk x 1.25": (kb, "conv3x3_wgrad",
                            lambda x, g, *, compute_dtype: 1.25 * d_orig(
                                x, g, compute_dtype=compute_dtype))}


def resident_reading(torch, res, cpu):
    """A resident step (``step_grads``) against the CPU's: the statistics of
    RESIDENT_STATS."""
    (la, ga), (lb, gb) = res, cpu
    out = {"loss_rel_err": ((la - lb).abs() / lb.abs()).max().item()}
    for label, net, names in (
            ("G", "G", list(gb["G"])), ("D", "D", list(gb["D"])),
            ("row0", "G", [n for n in gb["G"] if n.startswith("conv0_")
                           and n.endswith(("layer.0.weight",
                                           "layer.3.weight"))
                           and n != "conv0_0.layer.0.weight"])):
        a, b = (torch.cat([g[net][n].double().flatten() for n in names])
                for g in (ga, gb))
        out[f"{label} angle"] = 1 - float(a @ b) / float(a.norm() * b.norm())
        out[f"{label} scale"] = abs(float(a.norm() / b.norm()) - 1)
    return out


def resident_card_vs_cpu(torch, ka, kb, args):
    """One resident step (nf 16, 64x64, batch 2, bf16 compute, lr 0) on the
    card against the CPU's, beside its floor and three planted faults."""
    from tactile_gan_torch.core.config import TrainConfig

    cfg = TrainConfig(nf=STEP_NF, batch_size=STEP_BATCH,
                      image_size=STEP_SIZE, **RESIDENT)
    cpu = step_grads(torch, args, cfg, "cpu")
    def reading(dev, *perturb):
        return resident_reading(torch, step_grads(torch, args, cfg, dev,
                                                  *perturb), cpu)

    runs = {"card": reading("cuda")}
    for s in RESIDENT_FLOOR_SEEDS:
        runs[f"floor seed {s}"] = reading("cpu", RESIDENT_EPS, s)
    runs.update(faulty_runs(resident_faults(ka, kb), lambda: reading("cuda")))
    limits = {k: RESIDENT_FACTOR * max(r[k] for n, r in runs.items()
                                       if n.startswith("floor"))
              for k in RESIDENT_STATS}
    for k in RESIDENT_STATS[1:]:
        limits[k] = max(limits[k], RESIDENT_MIN)
    for name, r in runs.items():
        r["within_limits"] = all(r[k] <= limits[k] for k in RESIDENT_STATS)
        print(f"resident step vs CPU, {name}: "
              + ", ".join(f"{k} {r[k]:.3e}" for k in r
                          if k != "within_limits")
              + f"; within limits {r['within_limits']}", flush=True)
    print(f"resident step vs CPU: limits {limits} ({RESIDENT_FACTOR} x the "
          f"floor at eps {RESIDENT_EPS}, at least {RESIDENT_MIN} for an "
          "angle or a scale)", flush=True)
    missed = [n for n, r in runs.items() if n.startswith("fault")
              and r["within_limits"]]
    vacuous = [k for k in RESIDENT_STATS[1:] if not 0 < limits[k] < 0.5]
    if not runs["card"]["within_limits"] or missed or vacuous or not (
            limits["loss_rel_err"] > 0):
        raise AssertionError(f"resident step vs CPU: card {runs['card']}, "
                             f"limits {limits} (at or over half the "
                             f"ceiling: {vacuous}); planted faults not "
                             f"caught {missed}")
    return {"runs": runs, "limits": limits, "eps": RESIDENT_EPS,
            "factor": RESIDENT_FACTOR, "min": RESIDENT_MIN}


def resident_bits(torch, kb, args):
    """RESIDENT_BIT_STEPS graphed resident steps against as many eager ones
    from one state, batch and generator seed (cuDNN deterministic): every
    loss and parameter equal bit for bit; the stale relayout planted on the
    graphed run must break that."""
    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.utils.profiling import fixed_step

    def run(graphed):
        fs = fixed_step(TrainConfig(**RESIDENT), args.seed + 50)
        losses = torch.stack([fs() if graphed else fs.eager()
                              for _ in range(RESIDENT_BIT_STEPS)])
        flat = torch.cat([p.detach().flatten() for m in (fs.state.gen,
                                                         fs.state.disc)
                          for p in m.parameters()])
        del fs
        return losses, flat

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        eager = run(False)
        graphed = run(True)
        name, (owner, attr, faulty) = next(iter(graph_faults(torch, kb)
                                                .items()))
        orig = getattr(owner, attr)
        setattr(owner, attr, faulty)
        try:
            planted = run(True)
        finally:
            setattr(owner, attr, orig)
    finally:
        torch.backends.cudnn.deterministic = False
    equal = {k: all(torch.equal(a, b) for a, b in zip(res, eager))
             for k, res in (("graphed", graphed), (f"fault {name}", planted))}
    diff = (graphed[1] - eager[1]).abs()
    print(f"resident graphed vs eager, {RESIDENT_BIT_STEPS} steps: equal "
          f"bits {equal} (graphed max |param diff| {diff.max().item():.3e})",
          flush=True)
    if not equal["graphed"] or equal[f"fault {name}"]:
        raise AssertionError(f"resident graphed vs eager: {equal}")
    return equal


def phase_resident(torch, ka, kb, kd, args, record):
    """train.py's defaults with --bf16_resident --disc_bf16 beside the
    default step, graphed, in one call: exact launches a step, all of the
    resident step's on bf16 activations and none of the default's; ms a
    step, busy time, idle share, peak memory and the device split of each;
    graphed equal to eager bit for bit; the card against the CPU. A gate.
    Each kernel's bf16 shapes of the step are held against its plain
    version in phase kernels_training, and the parallel phase's
    dryrun_multichip(4) and (1) run the dry run's phase 2 resident."""
    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.utils.profiling import fixed_step, profile_calls

    out = {"card": card_line()}
    torch.backends.cudnn.allow_tf32 = True  # as a user runs it
    try:
        steps = {}
        for name, fields in (("default", {}), ("resident", RESIDENT)):
            torch.cuda.reset_peak_memory_stats()
            fs = fixed_step(TrainConfig(**fields), args.seed + 50)
            if (fs.state.gen.bf16_resident, fs.state.disc.resident) != (
                    bool(fields), bool(fields)):
                raise AssertionError(f"{name}: the flags did not reach the "
                                     "models")
            reset_counts(ka, kb, kd)
            for _ in range(RESIDENT_STEPS):
                losses = fs()
            torch.cuda.synchronize()
            counts, bf16 = launch_counts(ka, kb, kd), bf16_counts(ka, kb, kd)
            want = {k: v * RESIDENT_STEPS for k, v in PER_STEP.items()}
            want_bf16 = {k: want[k] if fields else 0 for k in bf16}
            if counts != want or bf16 != want_bf16:
                raise AssertionError(f"{name}: launches {counts}, bf16 "
                                     f"{bf16}; expected {want}, bf16 "
                                     f"{want_bf16}")
            if not torch.isfinite(losses).all():
                raise AssertionError(f"{name}: losses {losses}")
            res = profile_calls(fs, RESIDENT_REPS, warmup=1)
            res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            res["launches"], res["bf16_launches"] = counts, bf16
            steps[name] = res
            print(f"resident phase, {name} step (graphed, {out['card']}): "
                  f"{res['wall_ms']:.3f} ms/step, busy {res['busy_ms']:.3f} "
                  f"ms, idle {res['idle_share']:.4f}, peak "
                  f"{res['peak_mem_bytes'] / 2**30:.3f} GiB; device ms "
                  f"{res['device_ms']}; bf16 launches {bf16}", flush=True)
            del fs
        out["steps"] = steps
        out["bits"] = resident_bits(torch, kb, args)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    out["card_vs_cpu"] = resident_card_vs_cpu(torch, ka, kb, args)
    record["resident"] = out
    return out


# The other generators (phase other_generators): UNet and BCDUNet at nf 64,
# batch 4, 256x256, all other flags at train.py's defaults.
OTHER_GENS = ("UNet", "BCDUNet")
OTHER_PAIRS, OTHER_TEST_PAIRS = 16, 8  # 4 steps an epoch; 2 served batches
# UNet's deepest norm: 2x2 maps, one pixel a block (4 blocks an image).
DEEP_SHAPE = (TRAIN_BATCH, 2, 2, 512)
# A bias that feeds a non-affine norm has a true gradient of exactly 0; what
# a step computes for it must stay below this share of the largest
# gradient of its conv's weight.
ZERO_GRAD_SHARE = 1e-6


def zero_grad_biases(gen):
    """(bias, weight) names of the convs of ``gen`` whose bias feeds a
    non-affine instance norm (BCDUNet's double convs). The norm removes each
    channel's mean, so the bias's true gradient is 0 and what either side
    computes is rounding noise, which Adam (eps 1e-8) turns into updates of
    about the learning rate with an arbitrary sign: these are held to the
    noise floor and left out of the parameter comparison."""
    if gen != "BCDUNet":
        return ()
    blocks = [f"conv{i}" for i in range(1, 5)] + [f"conv{i}m"
                                                  for i in range(1, 4)]
    return tuple((f"{b}.{u}.bias", f"{b}.{u}.weight") for b in blocks
                 for u in (0, 3))


def generator_norm_shapes(torch, gen_name):
    """{(shape, affine): launches a forward} of every norm of ``gen_name``
    at nf 64, batch 4, 256x256, recorded from one forward on the card
    through the blocks module's instance_norm_act."""
    from tactile_gan_torch.models import blocks
    from tactile_gan_torch.models.factory import create_generator

    seen = {}
    real = blocks.instance_norm_act

    def spy(x, weight=None, bias=None, **kw):
        key = (tuple(x.shape), weight is not None)
        seen[key] = seen.get(key, 0) + 1
        return real(x, weight, bias, **kw)

    gen = create_generator(gen_name, nf=64,
                           compute_dtype=torch.bfloat16).cuda()
    blocks.instance_norm_act = spy
    try:
        with torch.no_grad():
            gen(torch.zeros(TRAIN_BATCH, FULL_RES, FULL_RES, 3,
                            device="cuda"))
    finally:
        blocks.instance_norm_act = real
    del gen
    return seen


def other_norm_rows(torch, ka, gen_name, shapes, seed, record):
    """A and C against their plain versions at every norm shape of
    ``gen_name``'s forward and step (float32 activations; affine or not,
    as the generator has them), with ms, GB/s, the bound, the plain
    version's and the library's ms; at UNet's 2x2x512 a fault planted on A
    and on C (block 0's partial left out of the merge) must fail the
    check."""
    import torch.nn.functional as F

    rng = torch.Generator(device="cuda").manual_seed(seed + 40)
    a_rows, c_rows = [], []
    for (shape, affine), per in shapes.items():
        c = shape[-1]
        x = torch.randn(shape, device="cuda", generator=rng) * 2 + 0.5
        g = torch.randn(shape, device="cuda", generator=rng)
        s = o = None
        if affine:
            s = 1 + 0.1 * torch.randn(c, device="cuda", generator=rng)
            o = 0.1 * torch.randn(c, device="cuda", generator=rng)
        y = ka.instance_norm_act(x, s, o, act="relu")
        _, st = ka.forward_kernel(x, s, o, "relu", 0.2)
        got = ka.backward_kernel(x, g, st, s, o, "relu", 0.2)
        torch.cuda.synchronize()
        ref = ka.instance_norm_act_plain(x, s, o, act="relu")
        want = ka.instance_norm_act_backward_plain(x, g, st, s, o,
                                                   act="relu")
        label = f"{gen_name} {list(shape)}"
        err_a = check_close(f"A {label}", y, ref, "float32")
        err_c = check_close(f"C {label}", got[0], want[0], "float32")
        if affine:
            for name, u, v in zip(("dscale", "doffset"), got[1:], want[1:]):
                check_share(f"C {label} {name}", u, v)
        plans = [norm_plan(ka, shape, torch.float32, k) for k in (1, 2)]
        if shape == DEEP_SHAPE:
            record[f"{gen_name}_deep_faults"] = {
                **planted_faults({"A block 0's partial left out":
                                  partial_left_out(torch, ka, x, None, None,
                                                   s, o, "relu", plans[0])},
                                 ref, f"kernel A at {label}"),
                **planted_faults({"C block 0's partial left out":
                                  partial_left_out(torch, ka, x, g, st, s, o,
                                                   "relu", plans[1])},
                                 want[0], f"kernel C at {label}")}
        xl = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        xg = xl.detach().requires_grad_()
        leaves = [xg] + ([s.clone().requires_grad_(),
                          o.clone().requires_grad_()] if affine else [])
        sl, ol = leaves[1:] if affine else (None, None)
        yl = torch.relu(F.instance_norm(xg, weight=sl, bias=ol, eps=ka.EPS))
        gl = g.permute(0, 3, 1, 2)
        for rows, name, err, inputs, plan, fn, plain, lib in (
                (a_rows, "A", err_a, 1, plans[0],
                 lambda: ka.instance_norm_act(x, s, o, act="relu"),
                 lambda: ka.instance_norm_act_plain(x, s, o, act="relu"),
                 lambda: torch.relu(F.instance_norm(
                     xl, weight=s, bias=o, eps=ka.EPS))),
                (c_rows, "C", err_c, 2, plans[1],
                 lambda: ka.backward_kernel(x, g, st, s, o, "relu", 0.2),
                 lambda: ka.instance_norm_act_backward_plain(
                     x, g, st, s, o, act="relu"),
                 lambda: torch.autograd.grad(yl, leaves, gl,
                                             retain_graph=True))):
            nbytes = (inputs + 1) * x.numel() * 4
            row = {"gen": gen_name, "shape": list(shape), "affine": affine,
                   "dtype": "float32", "per_forward": per, "per_step": per,
                   "max_abs_err": err, "tol": TOL["float32"],
                   "plan": plan._asdict(),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes"}
            row["ms"], row["call_ms"] = cuda_ms(fn)
            row["plain_ms"], _ = cuda_ms(plain)
            row["library_ms"], _ = cuda_ms(lib)
            row["gbps"] = nbytes / row["ms"] / 1e6
            rows.append(row)
            print(f"{name} {label} {'affine' if affine else 'non-affine'} "
                  f"x{per}: max|diff| {err:.3e} ms {row['ms']:.4f} "
                  f"({row['gbps']:.0f} GB/s, call {row['call_ms']:.4f}) "
                  f"plain {row['plain_ms']:.4f} library "
                  f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
                  f"({fmt_plan(plan)})", flush=True)
        del yl
    sums = {}
    for name, rows in (("A", a_rows), ("C", c_rows)):
        sums[name] = {k: sum(r[k] * r["per_step"] for r in rows)
                      for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"{name} a {gen_name} step: {sums[name]['ms']:.4f} ms (plain "
              f"{sums[name]['plain_ms']:.4f}, library "
              f"{sums[name]['library_ms']:.4f}, bound "
              f"{sums[name]['bound_ms']:.4f})", flush=True)
    return a_rows, c_rows, sums


def card_vs_cpu(torch, label, forward_of, x, limits=None):
    """A forward built by ``forward_of(compute, device)`` on the card
    against the CPU at ``x`` (float32, batch 1), in bf16 and f32 compute,
    within ``limits`` (compute -> (max, mean); by default the serve phase's
    SERVE_TOL)."""
    limits = {**SERVE_TOL, **(limits or {})}
    out = []
    for cd in ("bfloat16", "float32"):
        got = forward_of(cd, "cuda")(x.cuda()).cpu()
        want = forward_of(cd, "cpu")(x)
        d = (got - want).abs()
        max_tol, mean_tol = limits[cd]
        res = {"compute": cd, "max_abs": d.max().item(),
               "mean_abs": d.mean().item(), "max_tol": max_tol,
               "mean_tol": mean_tol}
        out.append(res)
        print(f"{label} card vs CPU ({cd}): max|diff| {res['max_abs']:.3e} "
              f"(tol {max_tol:.3g}), mean {res['mean_abs']:.3e} (tol "
              f"{mean_tol:.3g})", flush=True)
        if got.shape != tuple(x.shape[:3]) + (3,) or not (
                res["max_abs"] <= max_tol and res["mean_abs"] <= mean_tol):
            raise AssertionError(f"{label}: card and CPU disagree: {res}")
    return out


def train_serve_other(torch, ka, kb, kd, gen_name, args):
    """cli.train --gen ``gen_name`` on the card (graphed, two epochs,
    --checkpoint_interval 1) with its launch counts, artifacts and
    checkpoints checked; the trained folder served through evaluate_folder
    at eval_batch 4 with the serving counts; the trained generator's
    forward on the card against the CPU's at batch 1."""
    from tactile_gan_torch.eval import runner
    from tactile_gan_torch.utils.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as root:
        write_pairs(root, "train", chart_pairs(OTHER_PAIRS, FULL_RES,
                                               args.seed + 50))
        write_pairs(root, "test", chart_pairs(OTHER_TEST_PAIRS, FULL_RES,
                                              args.seed + 51))
        folder = f"train_{gen_name.lower()}"
        trainer, *run = train_run(torch, ka, kb, kd, root, folder, args, (
            "--gen", gen_name, "--checkpoint_interval", "1"))
        cfg = trainer.cfg
        if (cfg.gen, cfg.nf, cfg.batch_size, cfg.image_size) != (
                gen_name, 64, TRAIN_BATCH, FULL_RES):
            raise AssertionError(f"not the {gen_name} config at the "
                                 f"defaults: {cfg}")
        out = run_summary(trainer, *run)
        if sorted(trainer.graphed.captured) != [True]:
            raise AssertionError(f"{gen_name}: captured GP variants "
                                 f"{sorted(trainer.graphed.captured)}")
        model_dir = cfg.models_dir()
        for name in ["final_model.pth", "params.txt"] + [
                f"{k}loss.npy" for k in ("gen", "disc", "l1", "per", "gp")]:
            if not os.path.exists(os.path.join(model_dir, name)):
                raise AssertionError(f"{gen_name}: {name} not written")
        out["checkpoint_steps"] = {}
        for epoch in (1, 2):
            path = os.path.join(trainer.checkpoints_dir(),
                                f"model_{epoch}.pth")
            ckpt = load_checkpoint(path)
            out["checkpoint_steps"][epoch] = ckpt["step"]
            if ckpt["step"] != epoch * trainer.steps_per_epoch or set(
                    ckpt["gen"]) != set(trainer.gen.state_dict()):
                raise AssertionError(f"{path}: step {ckpt['step']}, "
                                     f"{len(ckpt['gen'])} generator tensors")
        print_run(f"{gen_name}, graphed, --checkpoint_interval 1", out)
        print(f"{gen_name} checkpoints read back at steps "
              f"{out['checkpoint_steps']}", flush=True)

        reset_counts(ka, kb, kd)
        metrics = runner.evaluate_folder(folder, work_root=root,
                                         eval_batch=TRAIN_BATCH,
                                         device="cuda")
        torch.cuda.synchronize()
        serve = launch_counts(ka, kb, kd)
        forwards = OTHER_TEST_PAIRS // TRAIN_BATCH
        want = {k: 0 for k in serve}
        want["instance_norm_act"] = A_PER_FORWARD_OF[gen_name] * forwards
        if serve != want or not all(math.isfinite(v)
                                    for v in metrics.values()):
            raise AssertionError(f"{gen_name}: serving launches {serve}, "
                                 f"expected {want}; metrics {metrics}")
        out["serve_launches"], out["serve_metrics"] = serve, metrics
        print(f"{gen_name}: served the trained folder: {metrics}; launches "
              f"{serve}", flush=True)

        ckpt = os.path.join(model_dir, "final_model.pth")
        out["programs"] = programs_vs_eager(
            torch, f"{gen_name} serve", runner.load_model(
                ckpt, cfg, device="cuda")[0], args.seed + 53)
        x = runner.normalize_u8(torch.from_numpy(
            chart_pairs(1, FULL_RES, args.seed + 52)[0][0][None]))
        out["card_vs_cpu"] = card_vs_cpu(
            torch, gen_name, lambda cd, dev: runner.load_model(
                ckpt, dataclasses.replace(cfg, compute_dtype=cd),
                device=dev)[0], x)
    return out


def gve_other(torch, args, cfg, label):
    """GVE_STEPS graphed steps of ``cfg`` against eager ones from one state,
    batch sequence and generator seed, within graph_vs_eager's limits
    (GVE_FACTOR times the eager-vs-eager floor, at least GVE_MIN); the
    zero-gradient biases left out of the parameters and their gradients
    held below ZERO_GRAD_SHARE in every run."""
    batches, vgg, schedule = gve_inputs(torch, args, cfg)
    watch = zero_grad_biases(cfg.gen)
    exclude = {b for b, _ in watch}
    torch.backends.cudnn.allow_tf32 = True
    try:
        eager, again, graphed = (
            gve_run(torch, args, cfg, batches, vgg, schedule, g, exclude,
                    watch) for g in (False, False, True))
    finally:
        torch.backends.cudnn.allow_tf32 = False

    def reading(res):
        (la, pa, _), (lb, pb, _) = res, eager
        return {"loss_rel": ((la - lb).abs() / lb.abs().clamp_min(1e-30))
                .max().item(),
                "param_mean_lr": ((pa - pb).abs().mean() / cfg.lr).item()}

    floor = reading(again)
    limits = {k: max(GVE_FACTOR * floor[k], GVE_MIN[k]) for k in floor}
    res = reading(graphed)
    # Each run's largest share and the bias it belongs to.
    ratios = {name: max(((v, b) for b, v in r[2].items()), default=None)
              for name, r in (("eager", eager), ("eager again", again),
                              ("graphed", graphed))}
    out = {"floor": floor, "limits": limits, "graphed": res,
           "zero_grad_biases": len(watch), "zero_grad_ratio": ratios,
           "zero_grad_share": ZERO_GRAD_SHARE}
    print(f"{label} graph vs eager, {GVE_STEPS} steps: floor {floor}; "
          f"limits {limits}; graphed {res}; zero-gradient biases "
          f"{len(watch)}, largest gradient share {ratios}", flush=True)
    if not all(res[k] <= limits[k] for k in limits):
        raise AssertionError(f"{label} graph vs eager: {res} outside "
                             f"{limits}")
    if watch and not all(r[0] <= ZERO_GRAD_SHARE for r in ratios.values()):
        raise AssertionError(f"{label}: a zero-gradient bias's gradient "
                             f"share {ratios} is above {ZERO_GRAD_SHARE}")
    return out


def phase_other_generators(torch, ka, kb, kd, args, record):
    """UNet and BCDUNet at nf 64, batch 4, 256x256: A and C at every norm
    shape; cli.train and evaluate_folder with exact launch counts (A and C
    each 28 a UNet step and 14 a BCDUNet step; no B, B-dx or D); the card's
    forward against the CPU's; graphed against eager steps."""
    from tactile_gan_torch.core.config import TrainConfig

    out = {}
    for gen_name in OTHER_GENS:
        shapes = generator_norm_shapes(torch, gen_name)
        if sum(shapes.values()) != A_PER_FORWARD_OF[gen_name] or any(
                affine == (gen_name == "BCDUNet") for _, affine in shapes):
            raise AssertionError(f"{gen_name}: norms of a forward {shapes}")
        a_rows, c_rows, sums = other_norm_rows(torch, ka, gen_name, shapes,
                                               args.seed, record)
        res = {"kernel_a": a_rows, "kernel_c": c_rows, "step_sums": sums}
        res["train"] = train_serve_other(torch, ka, kb, kd, gen_name, args)
        res["graph_vs_eager"] = gve_other(
            torch, args, TrainConfig(gen=gen_name), gen_name)
        out[gen_name] = res
    record["other_generators"] = out
    return out


# The variants (phase variants): train.py's flags that choose another
# function, each trained at nf 64, batch 4, 256x256 on 16 synthetic pairs.
VARIANT_RUNS = (
    ("version2_pan", ("--version", "2", "--lambda_per", "1")),
    ("loss_ce", ("--loss", "ce")),
    ("loss_w", ("--loss", "w", "--no_label_smoothing")),
    ("loss_hinge", ("--loss", "hinge")),
    ("legacy_label_cache", ("--legacy_label_cache",)),
    ("disc_same_pad", ("--disc_same_pad",)),
    ("no_host_aug", ("--no-host_aug",)),
    ("space_to_depth", ("--space_to_depth",)),
)
# Graphed against eager for these (TrainConfig fields).
VARIANT_GVE = (("version2_pan", dict(version=2, lambda_per=1.0)),
               ("no_host_aug", dict(host_aug=False)),
               ("space_to_depth", dict(space_to_depth=True)))
# The folded row 0 of --space_to_depth: (shape, launches a forward) of its
# norms at nf 64 (the trained width) and nf 32, batch 4, 256x256.
S2D_NORMS = {64: {((TRAIN_BATCH, 128, 128, 128), True): 10},
             32: {((TRAIN_BATCH, 128, 128, 64), True): 10}}
# --space_to_depth at nf 32, 64x64, batch 2: row 0 is 32x32x64, on B, B-dx
# and D; (Cin, launches a step) of its kernel convs.
S2D_NF32_SIZE, S2D_NF32_CINS = 64, ((64, 5), (128, 1), (192, 1), (256, 1),
                                    (320, 1))
# Device augmentation, card against CPU (tests/test_torch_augment.py's
# limits against JAX): the source within 1e-4 on the [0, 1] scale; at most
# 0.1% of the mask's values from another source pixel.
AUG_SRC_MAX, AUG_MASK_SHARE = 1e-4, 1e-3
TWO_STEP_PAIRS = 4


def variant_per_step(name):
    """Launches a step of a variant: UNet++'s, and no B, B-dx or D under
    --space_to_depth at nf 64 (row 0 is 128 channels wide)."""
    per = dict(PER_STEP)
    if name == "space_to_depth":
        per.update(conv3x3=0, conv3x3_dgrad=0, conv3x3_wgrad=0)
    return per


def mask_off(a, b):
    """The share of mask values taken from another source pixel: off by
    more than half a uint8 step."""
    return ((a - b).abs() > 0.5 / 255.0).float().mean().item()


def variants_augment(torch, args):
    """preprocess_batch with augmentation on the card against the CPU on the
    same uint8 batch and injected draws (two samples flipped, all four
    warped), its time, and a planted fault that must break the mask limit:
    the nearest mask sampled bilinearly."""
    from tactile_gan_torch.data import augment

    pairs = chart_pairs(TRAIN_BATCH, FULL_RES, args.seed + 60)
    src, tgt = (torch.from_numpy(np.stack([p[k] for p in pairs]))
                for k in (0, 1))
    drawn = augment.draw_augment(TRAIN_BATCH, FULL_RES, FULL_RES,
                                 torch.Generator().manual_seed(args.seed + 61),
                                 "cpu")
    draws = augment.AugmentDraws(
        torch.tensor([True, False] * (TRAIN_BATCH // 2)),
        torch.ones(TRAIN_BATCH, dtype=torch.bool), drawn.matrix)
    want = augment.preprocess_batch(src, tgt, augment=True, draws=draws)
    dsrc, dtgt = src.cuda(), tgt.cuda()
    ddraws = augment.AugmentDraws(*(t.cuda() for t in draws))

    def card():
        return augment.preprocess_batch(dsrc, dtgt, augment=True,
                                        draws=ddraws)

    got = [t.cpu() for t in card()]
    res = {"src_max": ((got[0] - want[0]).abs() / 2).max().item(),
           "mask_off": mask_off(got[1], want[1]),
           "limits": {"src_max": AUG_SRC_MAX, "mask_off": AUG_MASK_SHARE}}
    res["ms"], res["call_ms"] = cuda_ms(card)
    warp = augment.warp
    augment.warp = lambda img, m, *, nearest: warp(img, m, nearest=False)
    try:
        faulty = card()[1].cpu()
    finally:
        augment.warp = warp
    res["fault_mask_bilinear"] = mask_off(faulty, want[1])
    print(f"device augmentation, card vs CPU at batch {TRAIN_BATCH}, "
          f"{FULL_RES}^2: source max|diff| {res['src_max']:.3e} (limit "
          f"{AUG_SRC_MAX}), mask off {res['mask_off']:.3e} (limit "
          f"{AUG_MASK_SHARE}); {res['ms']:.4f} ms a batch (call "
          f"{res['call_ms']:.4f}); planted fault, mask sampled bilinearly: "
          f"mask off {res['fault_mask_bilinear']:.3e}", flush=True)
    if not (res["src_max"] <= AUG_SRC_MAX
            and res["mask_off"] <= AUG_MASK_SHARE):
        raise AssertionError(f"device augmentation: card and CPU disagree: "
                             f"{res}")
    if res["fault_mask_bilinear"] <= AUG_MASK_SHARE:
        raise AssertionError(f"device augmentation: the planted fault was "
                             f"not caught: {res}")
    return res


def variants_serve_s2d(torch, ka, kb, kd, args, root):
    """The trained --space_to_depth folder through cli.test (A only: 30 a
    forward), and its forward on the card against the CPU's."""
    from tactile_gan_torch.cli import test as test_cli
    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.eval import runner

    reset_counts(ka, kb, kd)
    metrics = test_cli.main(["--folder", "space_to_depth", "--work_root",
                             root, "--eval_batch", str(TRAIN_BATCH)])
    torch.cuda.synchronize()
    serve = launch_counts(ka, kb, kd)
    want = {k: 0 for k in serve}
    want["instance_norm_act"] = A_PER_FORWARD * (OTHER_TEST_PAIRS
                                                 // TRAIN_BATCH)
    if serve != want or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"--space_to_depth: serving launches {serve}, "
                             f"expected {want}; metrics {metrics}")
    print(f"--space_to_depth: served the trained folder: {metrics}; "
          f"launches {serve}", flush=True)
    model_dir = os.path.join(root, "models", "space_to_depth")
    cfg = TrainConfig.from_params_file(os.path.join(model_dir, "params.txt"))
    ckpt = os.path.join(model_dir, "final_model.pth")
    x = runner.normalize_u8(torch.from_numpy(
        chart_pairs(1, FULL_RES, args.seed + 62)[0][0][None]))
    return {"serve_launches": serve, "serve_metrics": metrics,
            "programs": programs_vs_eager(
                torch, "--space_to_depth serve", runner.load_model(
                    ckpt, cfg, device="cuda")[0], args.seed + 63),
            "card_vs_cpu": card_vs_cpu(
                torch, "--space_to_depth", lambda cd, dev: runner.load_model(
                    ckpt, dataclasses.replace(cfg, compute_dtype=cd),
                    device=dev)[0], x)}


def variants_nf32(torch, ka, kb, kd, args):
    """--space_to_depth at nf 32, 64x64, batch 2: one epoch of two steps
    through cli.train with UNet++'s counts a step (row 0, 32x32x64, on B,
    B-dx and D), then B, B-dx and D against their plain versions at every
    Cin of that row."""
    from tactile_gan_torch.cli import train as train_cli

    with tempfile.TemporaryDirectory() as root:
        write_pairs(root, "train", chart_pairs(2 * NF_BATCH, S2D_NF32_SIZE,
                                               args.seed + 63))
        reset_counts(ka, kb, kd)
        trainer = train_cli.main([
            "--data", os.path.join(root, "data"), "--nf", "32",
            "--image_size", str(S2D_NF32_SIZE), "--batch_size",
            str(NF_BATCH), "--total_epochs", "1", "--epoch_constant", "1",
            "--space_to_depth", "--folder_save", "s2d_nf32", "--seed",
            str(args.seed)])
        torch.cuda.synchronize()
        counts = launch_counts(ka, kb, kd)
    want = {k: v * trainer.state.step for k, v in PER_STEP.items()}
    losses = [v for k in ("gen", "disc", "l1", "gp", "per")
              for v in getattr(trainer, f"{k}_loss")]
    if counts != want or trainer.state.step != 2 or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"--space_to_depth nf 32: launches {counts}, "
                             f"expected {want}; losses {losses}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 64)
    cd, hw = torch.bfloat16, S2D_NF32_SIZE // 2
    rows = []
    for cin, per in S2D_NF32_CINS:
        x = torch.randn((NF_BATCH, hw, hw, cin), device="cuda", generator=gen)
        g = torch.randn((NF_BATCH, hw, hw, 64), device="cuda", generator=gen)
        wt = 0.05 * torch.randn((64, cin, 3, 3), device="cuda", generator=gen)
        y = kb.conv3x3(x, wt, compute_dtype=cd)
        dx = kb.dgrad_kernel(g, wt, cd)
        dk = kd.conv3x3_wgrad(x, g, compute_dtype=cd)
        torch.cuda.synchronize()
        label = f"--space_to_depth nf 32 row 0 cin {cin}"
        row = {"shape": list(x.shape), "co": 64, "per_step": per,
               "b": check_close(f"B {label}", y, kb.conv3x3_plain(
                   x, wt, compute_dtype=cd), "float32"),
               "b_dx": check_close(f"B-dx {label}", dx,
                                   kb.conv3x3_dgrad_plain(
                                       g, wt, compute_dtype=cd), "float32"),
               "d": check_share(f"D {label}", dk, kd.conv3x3_wgrad_plain(
                   x, g, compute_dtype=cd))}
        rows.append(row)
        print(f"{label}: max|diff| B {row['b']:.3e} B-dx {row['b_dx']:.3e} "
              f"D {row['d']:.3e}", flush=True)
    print(f"--space_to_depth nf 32: 2 steps, launches {counts}", flush=True)
    return {"launches": counts, "losses": losses, "rows": rows}


def chart_components(n, size, seed):
    """Synthetic charts with their three tactile components: (source, axes,
    grids, content), the axes, the bars and the polyline each black on
    white (the source as ``chart_pairs`` draws it)."""
    out = []
    for src, tac in chart_pairs(n, size, seed):
        axes = np.full((size, size), 255, np.uint8)
        base, left = size - 20, 20
        axes[base:base + 2, left:size - 10] = 0
        axes[10:base + 2, left:left + 2] = 0
        stroke = tac.min(axis=-1) == 0
        coloured = (src != 255).any(axis=-1) & ~(axes == 0)
        line = (src == (200, 30, 30)).all(axis=-1)
        grids = np.where(coloured & ~line & stroke, 0, 255).astype(np.uint8)
        content = np.where(line, 0, 255).astype(np.uint8)
        out.append((src, axes, grids, content))
    return out


def variants_two_step(torch, ka, kb, kd, args):
    """cli.two_step_test on the card: two seeded UNet++ nf 64 folders
    (stage 1 rgb, stage 2 ch) over synthetic charts with their three
    components; its launch counts, eval.txt and elm/; each stage and the
    chain on the card against the CPU's at batch 1."""
    from PIL import Image

    from tactile_gan_torch.cli import two_step_test
    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.eval import runner
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus
    from tactile_gan_torch.utils.checkpoint import save_checkpoint

    charts = chart_components(TWO_STEP_PAIRS, FULL_RES, args.seed + 65)
    with tempfile.TemporaryDirectory() as root:
        src_dir = os.path.join(root, "charts", "test", "source")
        tac_dir = os.path.join(root, "charts", "test", "tactile")
        os.makedirs(src_dir)
        os.makedirs(tac_dir)
        for i, (src, *comps) in enumerate(charts):
            Image.fromarray(src).save(os.path.join(src_dir, f"s_{i:04d}.png"))
            for name, comp in zip(("axes", "grids", "content"), comps):
                Image.fromarray(comp).save(
                    os.path.join(tac_dir, f"t_{i:04d}_{name}.tiff"))
        cfgs = {}
        for k, (folder, target) in enumerate((("s1", "rgb"), ("s2", "ch"))):
            cfg = TrainConfig(data="charts", target=target,
                              folder_save=folder, folder_load=folder)
            model_dir = os.path.join(root, "models", folder)
            os.makedirs(model_dir)
            cfg.save_params(model_dir)
            gen = UNetPlusPlus(nf=cfg.nf)
            init_weights(gen, torch.Generator().manual_seed(args.seed + 66
                                                            + k))
            save_checkpoint(os.path.join(model_dir, "final_model.pth"),
                            gen=gen.state_dict())
            cfgs[folder] = cfg
        reset_counts(ka, kb, kd)
        t0 = time.perf_counter()
        accuracy, dice, jaccard = two_step_test.main([
            "--s1_dir", "s1", "--s2_dir", "s2", "--data", "charts",
            "--work_root", root])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts(ka, kb, kd)
        want = {k: 0 for k in counts}
        want["instance_norm_act"] = 2 * A_PER_FORWARD * TWO_STEP_PAIRS
        want["conv3x3"] = 2 * B_PER_FORWARD * TWO_STEP_PAIRS
        out_dir = os.path.join(root, "Outputs", "s1+s2_charts")
        elm = sorted(os.listdir(os.path.join(out_dir, "elm")))
        metrics = {"accuracy": float(np.mean(accuracy)),
                   "dice": float(np.mean(dice)),
                   "jaccard": float(np.mean(jaccard))}
        print(f"two-step eval: {TWO_STEP_PAIRS} charts in {seconds:.2f} s; "
              f"{metrics}; launches {counts}; elm/ {elm}", flush=True)
        if counts != want or len(elm) != TWO_STEP_PAIRS or not (
                os.path.exists(os.path.join(out_dir, "eval.txt"))) or not all(
                math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"two-step eval: launches {counts}, "
                                 f"expected {want}; elm/ {elm}; {metrics}")

        def stage(folder):
            return lambda cd, dev: runner.load_model(
                os.path.join(root, "models", folder, "final_model.pth"),
                dataclasses.replace(cfgs[folder], compute_dtype=cd),
                device=dev)[0]

        def chain(cd, dev):
            return runner.ChainedForward(stage("s1")(cd, dev),
                                         stage("s2")(cd, dev))

        # Each stage alone within the serve phase's limits (stage 2 on the
        # CPU's stage-1 output); the chain in float32 within them too. In
        # bf16 stage 2 instance-normalizes stage 1's nearly flat output and
        # so magnifies any rounding: the chain's limit is at least twice
        # what bf16 compute alone moves it on the CPU (bf16 against f32).
        x = runner.normalize_u8(torch.from_numpy(charts[0][0][None]))
        out = {"seconds": seconds, "launches": counts, "metrics": metrics,
               "stage1": card_vs_cpu(torch, "two-step stage 1", stage("s1"),
                                     x)}
        mid = stage("s1")("bfloat16", "cpu")(x)
        out["stage2"] = card_vs_cpu(torch, "two-step stage 2", stage("s2"),
                                    mid)
        d = (chain("bfloat16", "cpu")(x) - chain("float32", "cpu")(x)).abs()
        out["bf16_floor"] = {"max_abs": d.max().item(),
                             "mean_abs": d.mean().item()}
        lim = SERVE_TOL["bfloat16"]
        print(f"two-step chain, bf16 against f32 on the CPU: "
              f"{out['bf16_floor']}", flush=True)
        out["chain"] = card_vs_cpu(torch, "two-step chain", chain, x, {
            "bfloat16": (max(lim[0], 2 * out["bf16_floor"]["max_abs"]),
                         max(lim[1], 2 * out["bf16_floor"]["mean_abs"]))})
        # The chain's programs: one graph for both stages, on stage 1.
        stages = [stage(f)(cfgs[f].compute_dtype, "cuda")
                  for f in ("s1", "s2")]
        chained = runner.ChainedForward(*stages)
        out["programs"] = programs_vs_eager(torch, "two-step chain",
                                            chained, args.seed + 69)
        if runner.ChainedForward(*stages).programs() is not \
                chained.programs() or stages[0].programs().programs:
            raise AssertionError("two-step chain: a new ChainedForward on "
                                 "the same pair did not find the chain's "
                                 "programs on stage 1")
        return out


def phase_variants(torch, ka, kb, kd, args, record):
    """train.py's variants at nf 64, batch 4, 256x256 through cli.train,
    graphed, each with its exact launch counts; graphed against eager for
    --version 2, --no-host_aug and --space_to_depth; the device augmentation
    card against CPU with a planted fault; the --space_to_depth folder
    served, its folded row's A and C against their plain versions (nf 64
    and 32), and at nf 32, 64x64 its B, B-dx and D; the augmentation
    preview; two-step eval. A gate."""
    from tactile_gan_torch.cli import visualize_augmentation as vis_cli
    from tactile_gan_torch.core.config import TrainConfig

    card = card_line()
    out = {"card": card, "train": {}}
    with tempfile.TemporaryDirectory() as root:
        write_pairs(root, "train", chart_pairs(OTHER_PAIRS, FULL_RES,
                                               args.seed + 67))
        write_pairs(root, "test", chart_pairs(OTHER_TEST_PAIRS, FULL_RES,
                                              args.seed + 68))
        for name, flags in VARIANT_RUNS:
            trainer, *run = train_run(torch, ka, kb, kd, root, name, args,
                                      flags)
            r = run_summary(trainer, *run, per=variant_per_step(name))
            r["flags"] = list(flags)
            if sorted(trainer.graphed.captured) != [True]:
                raise AssertionError(f"{name}: captured GP variants "
                                     f"{sorted(trainer.graphed.captured)}")
            # Every run keeps --lambda_per 1: the VGG term, or pan_loss
            # under version 2.
            if not min(r["losses"]["per"]) > 0:
                raise AssertionError(f"{name}: perceptual losses "
                                     f"{r['losses']['per']}")
            out["train"][name] = r
            print_run(f"variant {name} ({' '.join(flags)}; {card})", r)
            del trainer
        out["serve_s2d"] = variants_serve_s2d(torch, ka, kb, kd, args, root)
        # The augmentation preview, on the card by default.
        vis_dir = os.path.join(root, "augmentation_vis")
        vis_cli.main(["--data_dir", os.path.join(root, "data", "train",
                                                 "source"),
                      "--output_dir", vis_dir, "--num_samples", "2",
                      "--target_mode", "rgb"])
        out["visualize_augmentation"] = sorted(os.listdir(vis_dir))
        if len(out["visualize_augmentation"]) != 8:
            raise AssertionError(f"visualize_augmentation wrote "
                                 f"{out['visualize_augmentation']}")
    out["graph_vs_eager"] = {
        name: gve_other(torch, args, TrainConfig(**fields), name)
        for name, fields in VARIANT_GVE}
    out["augment"] = variants_augment(torch, args)
    out["s2d_norms"] = {}
    for nf, shapes in S2D_NORMS.items():
        a_rows, c_rows, sums = other_norm_rows(
            torch, ka, f"UNet++ --space_to_depth nf {nf}", shapes, args.seed,
            record)
        out["s2d_norms"][nf] = {"kernel_a": a_rows, "kernel_c": c_rows,
                                "step_sums": sums}
    out["s2d_nf32"] = variants_nf32(torch, ka, kb, kd, args)
    out["two_step"] = variants_two_step(torch, ka, kb, kd, args)
    record["variants"] = out
    return out


# ---------------------------------------------------------------------------
# Phase parallel: tactile_gan_torch/parallel (data and tensor parallelism),
# the DCP checkpoints of --ckpt_backend orbax, and tactile_gan_torch/entry.py.
# ---------------------------------------------------------------------------

PAR_PAIRS = 8         # (a): 2 steps an epoch, 4 steps in two epochs
PAR_RANKS = 2         # (b)-(d): ranks on cuda:0, gloo
PAR_DP_STEPS = 4      # (b)
PAR_TP_STEPS = 2      # (c)
PAR_TP_MIN = 256      # the trainer's split threshold (train/loop.py)
PAR_DEVICE = "cuda:0"  # the card the gloo ranks share
# (name, n_data, n_model, steps, planted fault or None) of the gloo runs.
PAR_RUNS = (("dp", PAR_RANKS, 1, PAR_DP_STEPS, None),
            ("dp fault: D all-reduce left out", PAR_RANKS, 1, PAR_DP_STEPS,
             "d_unreduced"),
            ("tp", 1, PAR_RANKS, PAR_TP_STEPS, None),
            ("tp fault: summing gather backward", 1, PAR_RANKS,
             PAR_TP_STEPS, "summing_gather"))


def par_state(torch, cfg, seed, device):
    """UNet++ and D at ``cfg`` from ``seed`` with their Adam pair, on
    ``device`` (a TrainState)."""
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import networks
    from tactile_gan_torch.train.state import TrainState, make_optimizer

    gen, disc = networks(cfg)
    init_weights(gen, torch.Generator().manual_seed(seed))
    init_weights(disc, torch.Generator().manual_seed(seed + 1))
    gen.to(device)
    disc.to(device)
    return TrainState(gen, disc,
                      make_optimizer(gen.parameters(), cfg.lr, cfg.beta1),
                      make_optimizer(disc.parameters(), cfg.lr, cfg.beta1))


def par_flat(torch, state):
    """Every parameter of G then D, full shape (split tensors gathered:
    collective), flattened into one float32 tensor on the host."""
    from tactile_gan_torch.parallel.tensor_parallel import full_state_dicts

    sd = full_state_dicts(state)
    return torch.cat([v.detach().flatten().float().cpu()
                      for k in ("gen", "disc") for v in sd[k].values()])


def par_inputs(torch, args, steps, label_shape):
    """(src, tgt, label noise, GP alpha) of each step at the global batch,
    on the host: chart pairs and seeded draws."""
    pairs = chart_pairs(steps * TRAIN_BATCH, FULL_RES, args.seed + 40)
    g = torch.Generator().manual_seed(args.seed + 41)
    out = []
    for i in range(steps):
        chunk = pairs[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
        out.append(tuple(torch.from_numpy(np.stack([p[k] for p in chunk]))
                         for k in (0, 1))
                   + (torch.randn((TRAIN_BATCH, *label_shape), generator=g),
                      torch.rand((TRAIN_BATCH, 1, 1, 1), generator=g)))
    return out


def par_steps(torch, cfg, state, step, inputs, device, rows=slice(None),
              perm=None):
    """Run ``step`` over ``inputs`` with the draws injected: this rank's
    ``rows`` of each batch, after permuting its rows by ``perm`` (batch
    and draws alike). (losses, seconds of each step)."""
    losses, seconds = [], []
    for src, tgt, noise, alpha in inputs:
        if perm is not None:
            src, tgt, noise, alpha = (t[perm] for t in (src, tgt, noise,
                                                        alpha))
        t0 = time.perf_counter()
        losses.append(step(state, src[rows].to(device), tgt[rows].to(device),
                           apply_gp=True, label_noise=noise,
                           gp_alpha=alpha).cpu())  # waits for the device
        seconds.append(time.perf_counter() - t0)
    return torch.stack(losses), seconds


def par_plant(fault):
    """Plant ``fault`` in this process (``plant`` of tests/torch_dist.py,
    the parallel tests' helpers); returns the undo."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_dist

    return torch_dist.plant(fault)


def par_split_in_two(torch, min_features):
    """Make every conv of the one-process step with ``min_features``
    output channels or more run as two convs on the halves of its weight
    and bias, concatenated: the arithmetic of a 1x2 tensor-parallel step
    in one process. Returns the undo."""
    from torch import nn

    from tactile_gan_torch.ops import conv as conv_ops

    orig = conv_ops.split_conv

    def split_in_two(layer, x, conv):
        dim = 1 if isinstance(layer, nn.ConvTranspose2d) else 0
        if layer.weight.shape[dim] < min_features:
            return conv(x)
        fn = conv_ops.conv2d_transpose if dim else conv_ops.conv2d
        biases = (layer.bias.chunk(2) if layer.bias is not None
                  else (None, None))
        return torch.cat([fn(x, w.contiguous(), stride=layer.stride[0],
                             padding=layer.padding[0], bias=b)
                          for w, b in zip(layer.weight.chunk(2, dim),
                                          biases)], dim=-1)
    conv_ops.split_conv = split_in_two
    return lambda: setattr(conv_ops, "split_conv", orig)


def par_rank(rank, world, root):
    """One gloo rank for (b)-(d) on the device, config and split threshold
    of root/spec.pt: each of PAR_RUNS from the seeded state over the
    spec's global inputs, then (after the tp run) a DCP save and a restore
    into a fresh state. Writes root/rank{rank}.pt: each run's losses, step
    times, launches, (tensor parallel) the gradients it computed for the
    parameters that are not split, before the average, and (rank 0) every
    parameter at full shape."""
    import torch
    import torch.distributed as dist

    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.models.vgg import load_vgg_features
    from tactile_gan_torch.ops.kernels import conv3x3 as kb
    from tactile_gan_torch.ops.kernels import conv3x3_wgrad as kd
    from tactile_gan_torch.ops.kernels import instance_norm as ka
    from tactile_gan_torch.parallel.mesh import local_batch_rows, make_mesh
    from tactile_gan_torch.parallel.tensor_parallel import shard_state_tp
    from tactile_gan_torch.parallel.rank_probe import unsplit_gradients
    from tactile_gan_torch.train.step import build_train_step
    from tactile_gan_torch.utils.dist_ckpt import DistCheckpointer, flat_state

    spec = torch.load(os.path.join(root, "spec.pt"))
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # The one-rank step's library settings (TF32 off: main()).
    torch.backends.cudnn.allow_tf32 = spec["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), world), rank=rank, world_size=world)
    cfg = TrainConfig(**spec["cfg"])
    vgg = load_vgg_features(device=dev)
    out = {}
    try:
        for name, n_data, n_model, steps, fault in PAR_RUNS:
            mesh = make_mesh(n_data, n_model)
            state = par_state(torch, cfg, spec["seed"], dev)
            shard_state_tp(mesh, state, spec["tp_min"])
            step = build_train_step(cfg, lambda s: cfg.lr, vgg, mesh)
            undo = par_plant(fault) if fault else None
            reset_counts(ka, kb, kd)
            rows = local_batch_rows(TRAIN_BATCH, mesh)
            r = {}
            try:
                with (unsplit_gradients() if n_model > 1
                      else contextlib.nullcontext([])) as raw:
                    losses, secs = par_steps(
                        torch, cfg, state, step,
                        spec["inputs"][:PAR_TP_STEPS], dev, rows)
                if steps > PAR_TP_STEPS:
                    r["params_2"] = par_flat(torch, state)
                    more = par_steps(torch, cfg, state, step,
                                     spec["inputs"][PAR_TP_STEPS:steps], dev,
                                     rows)
                    losses, secs = torch.cat([losses, more[0]]), secs + more[1]
            finally:
                if undo:
                    undo()
            r.update(losses=losses, seconds=secs,
                     launches=launch_counts(ka, kb, kd),
                     params=par_flat(torch, state), raw=[
                         torch.cat([g.flatten() for g in call])
                         for call in raw])
            if name == "tp":
                ck = DistCheckpointer(os.path.join(root, "orbax"),
                                      mesh.ckpt_group)
                ck.save(state.step, state)
                ck.wait()
                fresh = par_state(torch, cfg, spec["seed"] + 7, dev)
                shard_state_tp(mesh, fresh, spec["tp_min"])
                latest = ck.latest_step()
                ck.restore(latest, fresh)
                ck.close()
                a, b = flat_state(state), flat_state(fresh)
                r["dcp"] = {"latest": latest, "step": fresh.step,
                            "equal": fresh.step == state.step and all(
                                torch.equal(a[k].cpu(), b[k].cpu())
                                for k in a),
                            "split_keys": sum("@shard" in k for k in a)}
            if rank:
                r.pop("params")
                r.pop("params_2", None)
            out[name] = r
            del state, step
    finally:
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        dist.destroy_process_group()


def par_reading(cfg, res, ref):
    """Loss and parameter distance of one run from a reference run."""
    (la, pa), (lb, pb) = res, ref
    return {"loss_rel": ((la - lb).abs() / lb.abs().clamp_min(1e-30))
            .max().item(),
            "param_mean_lr": ((pa - pb).abs().mean() / cfg.lr).item()}


# The floors of (b) and (c): one-process runs whose arithmetic differs from
# the one-rank step's as a parallel step's does. Data parallelism sums the
# batch in another order; tensor parallelism, in addition, runs each split
# conv as two convs of half the output channels (other library algorithms)
# and sums their input gradients across the ranks.
PAR_FLOORS = {"dp": ("rows permuted",),
              "tp": ("rows permuted", "convs split in two")}


def parallel_gloo(torch, ka, kb, kd, args):
    """(b)-(d): PAR_RUNS on PAR_RANKS gloo ranks sharing cuda:0, each held
    to the one-rank step on the global batch in this process within
    GVE_FACTOR times the largest of its PAR_FLOORS, at least GVE_MIN; the
    faults must fall outside; every rank of a run must report rank 0's
    losses and (1x2) compute the bits of rank 0's gradients for the
    parameters that are not split; the DCP restore must equal the saved
    state."""
    import torch.multiprocessing as mp

    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.models.vgg import load_vgg_features
    from tactile_gan_torch.train.step import build_train_step

    dev = torch.device(PAR_DEVICE)
    # float32 compute (TF32 off, as main() sets it here and par_rank in the
    # ranks): in bf16 a split batch or a split conv that takes another
    # library algorithm moves roundings of the output by a bf16 ulp.
    cfg = TrainConfig(device=PAR_DEVICE, compute_dtype="float32")
    seed = args.seed + 43
    vgg = load_vgg_features(device=dev)
    probe = par_state(torch, cfg, seed, dev)
    with torch.no_grad():
        zeros = torch.zeros((1, FULL_RES, FULL_RES, 3), device=dev)
        label_shape = tuple(probe.disc(zeros, zeros)[0].shape[1:])
    inputs = par_inputs(torch, args, PAR_DP_STEPS, label_shape)
    g_params = sum(p.numel() for p in probe.gen.parameters())
    d_params = sum(p.numel() for p in probe.disc.parameters())
    del probe

    def one_rank(perm=None, split=False):
        state = par_state(torch, cfg, seed, dev)
        step = build_train_step(cfg, lambda s: cfg.lr, vgg)
        undo = par_split_in_two(torch, PAR_TP_MIN) if split else None
        res = {}
        try:
            for n in (PAR_TP_STEPS, PAR_DP_STEPS):
                losses, _ = par_steps(torch, cfg, state, step,
                                      inputs[:n] if n == PAR_TP_STEPS
                                      else inputs[PAR_TP_STEPS:n], dev,
                                      perm=perm)
                res[n] = (losses, par_flat(torch, state))
        finally:
            if undo:
                undo()
        res[PAR_DP_STEPS] = (torch.cat([res[PAR_TP_STEPS][0],
                                        res[PAR_DP_STEPS][0]]),
                             res[PAR_DP_STEPS][1])
        return res

    # cuDNN's deterministic algorithms on both sides: the floor then holds
    # the reordered sums and no run-to-run atomics.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        ref = one_rank()
        floor_runs = {"rows permuted": one_rank(torch.tensor([2, 3, 0, 1])),
                      "convs split in two": one_rank(split=True)}
        with tempfile.TemporaryDirectory() as root:
            torch.save({"seed": seed, "inputs": inputs, "device": PAR_DEVICE,
                        "tp_min": PAR_TP_MIN,
                        "tf32": torch.backends.cudnn.allow_tf32,
                        "cfg": dataclasses.asdict(cfg)},
                       os.path.join(root, "spec.pt"))
            t0 = time.perf_counter()
            mp.start_processes(par_rank, args=(PAR_RANKS, root),
                               nprocs=PAR_RANKS, start_method="spawn")
            spawn_s = time.perf_counter() - t0
            ranks = [torch.load(os.path.join(root, f"rank{r}.pt"))
                     for r in range(PAR_RANKS)]
    finally:
        torch.backends.cudnn.deterministic = False
    out = {"ranks": PAR_RANKS, "spawn_s": spawn_s, "runs": {},
           "floor_runs": {}, "floor": {}, "limits": {}}
    for n in (PAR_TP_STEPS, PAR_DP_STEPS):
        each = {name: par_reading(cfg, r[n], ref[n])
                for name, r in floor_runs.items()}
        out["floor_runs"][str(n)] = each
        print(f"parallel floors after {n} steps: {each}", flush=True)
    for kind, steps in (("dp", PAR_DP_STEPS), ("tp", PAR_TP_STEPS)):
        each = out["floor_runs"][str(steps)]
        floor = {k: max(each[f][k] for f in PAR_FLOORS[kind])
                 for k in GVE_MIN}
        out["floor"][kind] = floor
        out["limits"][kind] = {k: max(GVE_FACTOR * floor[k], GVE_MIN[k])
                               for k in floor}
    # A 1x2 step is the split-in-two step's arithmetic in two processes.
    out["tp_from_split_in_two"] = par_reading(
        cfg, (ranks[0]["tp"]["losses"], ranks[0]["tp"]["params"]),
        floor_runs["convs split in two"][PAR_TP_STEPS])
    print(f"parallel (c) tp against the one-process step with its convs "
          f"split in two: {out['tp_from_split_in_two']}", flush=True)
    unequal = []
    for name, n_data, n_model, steps, fault in PAR_RUNS:
        kind = "tp" if n_model > 1 else "dp"
        limits = out["limits"][kind]
        r0 = ranks[0][name]
        reading = par_reading(cfg, (r0["losses"], r0["params"]),
                              ref[steps])
        reading["within_limits"] = all(reading[k] <= limits[k]
                                       for k in limits)
        # Every rank reports its own losses (averaged over its data group),
        # and under 1x2 each computes the gradients of the parameters that
        # are not split itself, before the average evens out library sums:
        # with cuDNN deterministic, a rank that computed something else
        # shows here.
        reading["ranks_equal"] = (
            n_model == 1 or len(r0["raw"]) == 2 * steps) and all(
            torch.equal(r0["losses"], rr[name]["losses"])
            and len(r0["raw"]) == len(rr[name]["raw"])
            and all(torch.equal(a, b) for a, b in zip(r0["raw"],
                                                      rr[name]["raw"]))
            for rr in ranks[1:])
        if not fault and not reading["ranks_equal"]:
            unequal.append(name)
        ms = [s * 1e3 for s in r0["seconds"]]
        reading.update(mesh=f"{n_data}x{n_model}", steps=steps,
                       ms_per_step=ms, launches=[rr[name]["launches"]
                                                 for rr in ranks])
        if not fault:
            want = {k: v * steps for k, v in PER_STEP.items()}
            if any(rr[name]["launches"] != want for rr in ranks):
                raise AssertionError(f"parallel {name}: launches "
                                     f"{reading['launches']}, expected "
                                     f"{want} a rank")
        if "dcp" in r0:
            reading["dcp"] = [rr[name]["dcp"] for rr in ranks]
        if "params_2" in r0:
            reading["after_2_steps"] = par_reading(
                cfg, (r0["losses"][:PAR_TP_STEPS], r0["params_2"]),
                ref[PAR_TP_STEPS])
        out["runs"][name] = reading
        print(f"parallel (gloo, {PAR_RANKS} ranks on cuda:0, eager) {name}: "
              f"mesh {n_data}x{n_model}, {steps} steps, ms/step "
              f"{[round(m, 2) for m in ms]}; loss_rel "
              f"{reading['loss_rel']:.3e}, param_mean_lr "
              f"{reading['param_mean_lr']:.3e} (floor {out['floor'][kind]}, "
              f"limits {limits}); ranks equal {reading['ranks_equal']}; "
              f"after 2 steps {reading.get('after_2_steps')}", flush=True)
    out.update(allreduce_bytes_per_step=4 * (g_params + d_params + 5),
               g_params=g_params, d_params=d_params)
    runs = out["runs"]
    bad = ([n for n, _, _, _, f in PAR_RUNS if not f
            and not runs[n]["within_limits"]]
           + [n for n, _, _, _, f in PAR_RUNS if f
              and runs[n]["within_limits"]])
    print(f"parallel: {out['allreduce_bytes_per_step']:,} bytes all-reduced "
          f"a data-parallel step (counted: {g_params:,} G and {d_params:,} "
          "D float32 parameters and the 5 losses)", flush=True)
    dcp = runs["tp"]["dcp"]
    print(f"parallel (d) DCP save under 1x{PAR_RANKS} TP, restore at the "
          f"latest step into a fresh state: {dcp}", flush=True)
    if bad or unequal or not all(d["equal"] and d["latest"] == PAR_TP_STEPS
                                 and d["split_keys"] > 0 for d in dcp):
        raise AssertionError(f"parallel gloo: out of limits or fault not "
                             f"caught: {bad}; ranks unequal: {unequal}; "
                             f"DCP {dcp}")
    return out


def parallel_nccl(torch, ka, kb, kd, args):
    """(a): cli.train at its defaults, graphed, for 4 steps, first without
    a process group and then as rank 0 of a one-rank NCCL group (a file
    store, this process): exact counts, equal bits (cuDNN deterministic in
    both), and each run's graphed step under the profiler."""
    import torch.distributed as dist

    from tactile_gan_torch.utils.profiling import profile_calls

    out = {}
    flats, losses = {}, {}
    dev = torch.device("cuda")
    shape = (TRAIN_BATCH, FULL_RES, FULL_RES, 3)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 44)
    src, tgt = (torch.randint(0, 256, shape, generator=gen, device=dev,
                              dtype=torch.uint8) for _ in range(2))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory() as root:
            write_pairs(root, "train", chart_pairs(PAR_PAIRS, FULL_RES,
                                                   args.seed + 42))
            for name in ("plain", "nccl"):
                if name == "nccl":
                    dist.init_process_group("nccl", store=dist.FileStore(
                        os.path.join(root, "store"), 1), rank=0,
                        world_size=1)
                try:
                    trainer, *run = train_run(torch, ka, kb, kd, root,
                                              f"par_{name}", args)
                    r = run_summary(trainer, *run)
                    mesh = trainer.mesh
                    if (name == "nccl") != (mesh is not None) or (
                            mesh is not None and (mesh.backend, mesh.shape)
                            != ("nccl", {"data": 1, "model": 1})):
                        raise AssertionError(f"parallel {name}: mesh {mesh}")
                    if sorted(trainer.graphed.captured) != [True]:
                        raise AssertionError(f"parallel {name}: captured "
                                             f"{trainer.graphed.captured}")
                    flats[name] = par_flat(torch, trainer.state)
                    losses[name] = [r["losses"][k] for k in sorted(
                        r["losses"])]
                    r["profile"] = profile_calls(
                        lambda: trainer._step(src, tgt, True), reps=3,
                        warmup=1)
                    out[name] = r
                    print_run(f"parallel (a) {name}", r)
                    p = r["profile"]
                    print(f"parallel (a) {name} graphed step under the "
                          f"profiler: host wall {p['wall_ms']:.2f} ms, busy "
                          f"{p['busy_ms']:.2f} ms, idle {p['idle_share']:.3f}"
                          f", host launches {p['host_launches']}",
                          flush=True)
                    del trainer
                finally:
                    if name == "nccl":
                        dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = False
    out["bit_equal"] = (torch.equal(flats["plain"], flats["nccl"])
                        and losses["plain"] == losses["nccl"])
    print(f"parallel (a): 4 graphed steps, one-rank NCCL against no process "
          f"group, equal bits: {out['bit_equal']}", flush=True)
    if not out["bit_equal"]:
        diff = (flats["plain"] - flats["nccl"]).abs()
        raise AssertionError(f"parallel (a): the NCCL run differs: max "
                             f"{diff.max().item():.3e}, {int((diff > 0).sum())}"
                             f" of {diff.numel()} parameters; losses "
                             f"{losses}")
    return out


def phase_parallel(torch, ka, kb, kd, args, record):
    """The parallel layer: (a) the trainer in a one-rank NCCL group,
    graphed; (b) data parallelism and (c) tensor parallelism over gloo
    ranks sharing cuda:0, each against the one-rank step with a planted
    fault; (d) the DCP checkpoint of --ckpt_backend orbax saved under (c)
    and restored; (e) entry() and dryrun_multichip(4) (gloo on one card)
    and (1) (NCCL) on the card. A gate."""
    from tactile_gan_torch.entry import dryrun_multichip, entry

    card = card_line()
    out = {"card": card}
    out["nccl_ws1"] = parallel_nccl(torch, ka, kb, kd, args)
    out["gloo"] = parallel_gloo(torch, ka, kb, kd, args)
    fn, (x,) = entry()
    y = fn(x)
    torch.cuda.synchronize()
    if tuple(y.shape) != tuple(x.shape) or not torch.isfinite(y).all():
        raise AssertionError(f"entry(): output {tuple(y.shape)}, finite "
                             f"{bool(torch.isfinite(y).all())}")
    out["entry"] = {"shape": list(y.shape), "device": str(y.device)}
    out["dryrun_multichip_s"] = {}
    for n in (4, 1):
        t0 = time.perf_counter()
        dryrun_multichip(n)
        out["dryrun_multichip_s"][n] = time.perf_counter() - t0
    print(f"parallel (e): entry() {out['entry']}; dryrun_multichip(4, 1) on "
          f"{card} in {out['dryrun_multichip_s']} s", flush=True)
    record["parallel"] = out
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


def programs_vs_eager(torch, label, forward, seed):
    """The forward's graphed u8_eval and f32 programs (eval/graph.py)
    against the same programs run eagerly on the card, bit for bit, at
    batch 1 and 4: on a first batch (the capture's call), a second one (a
    replay) and the first again. Each program is captured once."""
    from tactile_gan_torch.eval.graph import ServingPrograms

    pairs = chart_pairs(8, FULL_RES, seed)
    eager = ServingPrograms(forward.gen, forward.device, graphed=False)
    programs = forward.programs()
    before = programs.captures
    out = {"calls": 0}
    for b in (1, 4):
        batches = [tuple(torch.from_numpy(np.stack([p[j] for p in
                                                    pairs[k * b:(k + 1) * b]]))
                         .cuda() for j in (0, 1)) for k in (0, 1)]
        for mode in ("u8_eval", "f32"):
            for src, tgt in (batches[0], batches[1], batches[0]):
                tgt = tgt if mode == "u8_eval" else None
                got, want = programs(mode, src, tgt), eager(mode, src, tgt)
                out["calls"] += 1
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{label}: the graphed {mode} "
                                         f"program at batch {b} differs from "
                                         "the eager one")
    out["captures"] = programs.captures - before
    out["capture_s"] = {f"{k[0]} {k[1][0]}": p.capture_s
                        for k, p in programs.programs.items()}
    print(f"{label}: graphed u8_eval and f32 programs equal the eager ones "
          f"bit for bit at batch 1 and 4 ({out['calls']} calls, "
          f"{out['captures']} captures: {out['capture_s']})", flush=True)
    if out["captures"] != 4:
        raise AssertionError(f"{label}: {out['captures']} captures, "
                             "expected 4")
    return out


def artifacts(out_dir):
    """Every file a serving run wrote under ``out_dir`` (out/, sgt/, elm/,
    eval.txt): relative name -> bytes."""
    found = {}
    for base, _, files in os.walk(out_dir):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                found[os.path.relpath(path, out_dir)] = f.read()
    return found


def differing(a, b):
    """Names whose bytes differ between two ``artifacts`` (or are missing
    from one)."""
    return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


# The planted faults of the serve phase's programs. A drain behind its
# replay is what four batches in flight allow: the late drain of the
# uncloned fault sleeps DRAIN_LAG_S before its copy.
DRAIN_LAG_S = 0.02


def serve_faults(torch, runner, graph, load, dataset, root, want):
    """Two faults planted on the graphed programs, each served through
    test_model with a fresh forward; each must change the artifacts
    against the eager run's ``want`` (eval_batch -> the PNGs)."""
    def stale_stage(self, prog, batch):  # the replay keeps batch 1
        return None

    def uncloned(self, prog):  # the graph's own outputs to the drain
        return prog.outputs

    def late_to_host(t, _to_host=runner.to_host):
        time.sleep(DRAIN_LAG_S)
        return _to_host(t)

    plants = (("replay without the copy into the static input", 1,
               ((graph.ServingPrograms, "_stage", stale_stage),)),
              ("static output handed to a late drain", 4,
               ((graph.ServingPrograms, "_take", uncloned),
                (runner, "to_host", late_to_host))))
    out = {}
    for name, eval_batch, patches in plants:
        out_dir = os.path.join(root, "fault", str(eval_batch))
        with contextlib.ExitStack() as stack:
            for obj, attr, value in patches:
                stack.enter_context(patched(obj, attr, value))
            runner.test_model(load(), dataset, out_dir, evaluation=True,
                              eval_batch=eval_batch, threads=8)
        torch.cuda.synchronize()
        got = {k: v for k, v in artifacts(out_dir).items()
               if k.endswith(".png")}
        bad = differing(got, want[eval_batch])
        out[name] = len(bad)
        print(f"serve fault planted ({name}, eval_batch {eval_batch}): "
              f"{len(bad)} of {len(got)} PNGs differ from the eager run",
              flush=True)
        if not bad:
            raise AssertionError(f"serve fault not caught: {name}")
    return out


def phase_serve(torch, ka, kb, args, record):
    import gc
    import io
    import weakref

    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.data.dataset import PairedDataset
    from tactile_gan_torch.eval import graph, runner
    from tactile_gan_torch.eval.visualize import can_plot
    from tactile_gan_torch.models.blocks import init_weights
    from tactile_gan_torch.models.factory import create_generator
    from tactile_gan_torch.utils.checkpoint import save_checkpoint

    card = card_line()
    flow = "evaluate_folder, plots " + (
        "drawn" if can_plot() else "skipped (matplotlib is not installed)")
    print(f"serving flow: {flow}", flush=True)
    pairs = chart_pairs(args.images, FULL_RES, args.seed)
    out = {"card": card, "flow": flow, "images": args.images, "forward": [],
           "runs": []}
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
        out["programs"] = programs_vs_eager(torch, "UNet++ serve", forward,
                                            args.seed + 1)

        # evaluate_folder eager and graphed in turns (eager, graphed,
        # graphed, eager) at each eval batch, with TACTILE_EVAL_TIMING.
        out_dir = os.path.join(root, "Outputs", "smoke")
        written = {}
        os.environ["TACTILE_EVAL_TIMING"] = "1"
        try:
            for eval_batch in (1, 4):
                for graphed in (False, True, True, False):
                    # Every file compared is one this run wrote.
                    shutil.rmtree(out_dir, ignore_errors=True)
                    ka.instance_norm_act.launches = 0
                    kb.conv3x3.launches = 0
                    text = io.StringIO()
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(text):
                        metrics = runner.evaluate_folder(
                            "smoke", work_root=root, eval_batch=eval_batch,
                            device="cuda", graphed=graphed)
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    sys.stdout.write(text.getvalue())
                    timing = [ln for ln in text.getvalue().splitlines()
                              if ln.startswith("[eval timing]")]
                    n_a, n_b = ka.instance_norm_act.launches, kb.conv3x3.launches
                    forwards = -(-args.images // eval_batch)
                    run = {"eval_batch": eval_batch, "graphed": graphed,
                           "seconds": wall, "img_per_s": args.images / wall,
                           "forwards": forwards, "launches_a": n_a,
                           "launches_b": n_b, "metrics": metrics,
                           "timing": timing}
                    out["runs"].append(run)
                    print(f"serve eval_batch {eval_batch} "
                          f"{'graphed' if graphed else 'eager'}: "
                          f"{args.images} images in {wall:.3f} s = "
                          f"{run['img_per_s']:.2f} img/s; launches A {n_a} "
                          f"B {n_b} over {forwards} forwards; {metrics}; "
                          f"{card}", flush=True)
                    if (n_a, n_b) != (A_PER_FORWARD * forwards,
                                      B_PER_FORWARD * forwards):
                        raise AssertionError(
                            f"expected {A_PER_FORWARD} A and {B_PER_FORWARD} "
                            f"B launches per forward, got A {n_a} B {n_b} "
                            f"over {forwards}")
                    if not all(math.isfinite(v) for v in metrics.values()):
                        raise AssertionError(f"non-finite metrics {metrics}")
                    if len(timing) != 1:
                        raise AssertionError(f"eval timing lines {timing}")
                    found = artifacts(out_dir)
                    if sum(k.startswith("out") for k in found) != args.images \
                            or "eval.txt" not in found:
                        raise AssertionError(f"artifacts missing: "
                                             f"{sorted(found)[:8]}")
                    if (eval_batch, graphed) not in written:
                        written[(eval_batch, graphed)] = found
                bad = differing(written[(eval_batch, True)],
                                written[(eval_batch, False)])
                if bad:
                    raise AssertionError(f"eval_batch {eval_batch}: graphed "
                                         f"artifacts differ from eager: "
                                         f"{bad[:8]} ({len(bad)})")
                print(f"serve eval_batch {eval_batch}: graphed artifacts "
                      f"equal the eager run's byte for byte "
                      f"({len(written[(eval_batch, True)])} files)",
                      flush=True)
        finally:
            del os.environ["TACTILE_EVAL_TIMING"]

        # One forward serving twice through test_model: one capture.
        dataset = PairedDataset(os.path.join(root, "data", "test", "source"),
                                size=cfg.image_size, mode="test")

        def load():
            return runner.load_model(ckpt, cfg, device="cuda")[0]

        served = load()
        captures = []
        for k in range(2):
            runner.test_model(served, dataset, os.path.join(root, "again",
                                                            str(k)),
                              evaluation=True, eval_batch=4, threads=8)
            captures.append(served.programs().captures)
        out["test_model_captures"] = captures
        print(f"test_model twice on one forward: captures after each "
              f"{captures}", flush=True)
        if captures != [1, 1]:
            raise AssertionError(f"test_model captures {captures}, expected "
                                 "[1, 1]")
        # The graphs die with their forward.
        ref = weakref.ref(served.programs())
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        del served
        gc.collect()
        out["programs_freed"] = ref() is None
        out["freed_bytes"] = held - torch.cuda.memory_allocated()
        print(f"programs dead after del forward: {out['programs_freed']}; "
              f"{out['freed_bytes']} device bytes freed", flush=True)
        if not out["programs_freed"]:
            raise AssertionError("the serving programs outlived their "
                                 "forward")
        out["faults"] = serve_faults(
            torch, runner, graph, load, dataset, root,
            {b: {k: v for k, v in written[(b, False)].items()
                 if k.endswith(".png")} for b in (1, 4)})

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


BENCH_BUDGET_S = 300
BENCH_TIMEOUT_S = 600
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
MFU_MAX = 1.05
# The flop count held card against CPU: a small step (row 0 on B's tail).
BENCH_FLOPS_SHAPE = dict(nf=8, size=64, batch=2)


def phase_bench(torch, args, record):
    """``python -m tactile_gan_torch.cli.bench --budget_s 300`` in a
    subprocess (the kernels are built): exactly one line on stdout that
    parses, with the five keys, a finite positive value, the card's name,
    0 < MFU <= 1.05, a number in every matrix entry and the default step's
    launches (30 A, 30 C, 9 B, 9 B-dx, 9 D). Then the step's flop count
    at nf 8, 64x64, batch 2 on the card (FlopCounterMode plus the conv
    wrappers' counts) must equal the same step's on the CPU (the plain
    versions, which FlopCounterMode counts), exactly."""
    from tactile_gan_torch.cli import bench

    out = os.path.join(os.path.dirname(args.out) or ".", "bench.json")
    proc = subprocess.run(
        [sys.executable, "-m", "tactile_gan_torch.cli.bench", "--budget_s",
         str(BENCH_BUDGET_S), "--seed", str(args.seed), "--out", out],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"cli.bench exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"cli.bench printed {len(lines)} lines on "
                             f"stdout: {proc.stdout[-2000:]!r}")
    res = json.loads(lines[0])
    print(f"bench: {lines[0]}", flush=True)
    extra = res["extra"]
    matrix = extra["throughput_matrix"]
    launches = extra["throughput_matrix_launches"]["b4"]
    want = {"A": 30, "C": 30, "B": 9, "B-dx": 9, "D": 9}
    checks = {
        "five keys": set(res) == BENCH_KEYS,
        "value finite and > 0": (isinstance(res["value"], float)
                                 and math.isfinite(res["value"])
                                 and res["value"] > 0),
        "device names the card": (extra["device"]["kind"]
                                  == torch.cuda.get_device_name(0)),
        "power limit read": isinstance(extra["device"]["power_limit_w"],
                                       float),
        f"0 < mfu <= {MFU_MAX}": (isinstance(extra["mfu_estimate"], float)
                                  and 0 < extra["mfu_estimate"] <= MFU_MAX),
        "every matrix entry a number": all(
            isinstance(v, float) for v in matrix.values()),
        "b4 launches a step": launches == want,
        "median of >= 3 trials": len(extra["trials_images_per_sec"]) >= 3,
    }
    flops = {dev: bench.step_flops(**BENCH_FLOPS_SHAPE, device=dev,
                                   seed=args.seed) for dev in ("cuda", "cpu")}
    checks["flops card == cpu"] = flops["cuda"] == flops["cpu"]
    print(f"bench: step flops at {BENCH_FLOPS_SHAPE}: card {flops['cuda']}, "
          f"cpu {flops['cpu']}; checks {checks}", flush=True)
    record["bench"] = {"line": res, "flops_small": flops, "checks": checks,
                       "stderr_tail": proc.stderr[-4000:]}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench: failed {failed}; b4 launches "
                             f"{launches}; matrix {matrix}")
    return res


QUALITY_ARGV = ["--batch", "4", "--version", "2", "--epochs", "30",
                "--seed", "21"]
QUALITY_DICE_FLOOR = 0.9950 - 0.01
QUALITY_L1_DROP = 4.0
# cli.quality names each count by its wrapper (train/graph.py's
# LAUNCH_COUNTERS); the two that this script names otherwise.
WRAPPER_KEYS = {"backward_kernel": "instance_norm_act_backward",
                "dgrad_kernel": "conv3x3_dgrad"}


def phase_quality(torch, ka, kb, kd, record):
    """cli.quality at scripts/quality_run.sh's b4 --version 2 config on
    cuda in a temporary work root, the launch counters set to 0 just before
    and read just after: exact launches a step and a served image, finite
    losses, L1 down by QUALITY_L1_DROP, Dice at or above its floor."""
    from tactile_gan_torch.cli import quality

    torch.backends.cudnn.allow_tf32 = True  # as a user runs it
    with tempfile.TemporaryDirectory() as work:
        reset_counts(ka, kb, kd)
        res = quality.main(QUALITY_ARGV + ["--work", work])
        torch.cuda.synchronize()
        counts = launch_counts(ka, kb, kd)
        torch.backends.cudnn.allow_tf32 = False
        model_dir = os.path.join(work, "models", res["config"]["tag"])
        losses = {name: np.load(os.path.join(model_dir, f"{name}loss.npy"))
                  for name in ("gen", "disc", "l1", "per", "gp")}
    served = res["config"]["n_test"]  # one forward an image at eval_batch 1
    want = {k: v * res["steps"] for k, v in PER_STEP.items()}
    want["instance_norm_act"] += A_PER_FORWARD * served
    want["conv3x3"] += B_PER_FORWARD * served
    checks = {
        "launches": counts == want,
        "launches a step": {WRAPPER_KEYS.get(k, k): v for k, v in
                            res["launches_per_step"].items()}
        == {k: float(v) for k, v in PER_STEP.items()},
        "finite losses": all(len(v) == res["config"]["epochs"]
                             and np.all(np.isfinite(v))
                             for v in losses.values()),
        f"L1 down {QUALITY_L1_DROP:g}x": (res["l1_last"] * QUALITY_L1_DROP
                                          <= res["l1_first"]),
        f"Dice >= {QUALITY_DICE_FLOOR:.4f}": res["dice"] >= QUALITY_DICE_FLOOR,
    }
    print(f"quality: {json.dumps(res)}", flush=True)
    print(f"quality: launches {counts}; checks {checks}", flush=True)
    record["quality"] = {"line": res, "launches": counts, "checks": checks}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"quality: failed {failed}; launches {counts}, "
                             f"expected {want}")
    return {"launches": counts}


def phase_probe(torch, ka, kb, kd, record, parent):
    """The conv probe entry point at its defaults on cuda with the launch
    counters around it; then kernel E, through both names, against its
    plain version at the probe's inputs, with times and bounds (and the
    parent's, from ``parent``); a fault planted on E must fail that
    check."""
    from tactile_gan_torch.cli import probe_conv

    reset_counts(ka, kb, kd)
    res = probe_conv.main([])
    torch.cuda.synchronize()
    counts = launch_counts(ka, kb, kd)
    want = {k: res["calls"].get(k, 0) for k in counts}
    print(f"probe launches {counts}; calls made {res['calls']}", flush=True)
    if counts != want:
        raise AssertionError(f"probe launches {counts}, expected {want}")
    rows = {"conv3x3_p1": [], "conv3x3_p1_h": []}
    for (cin, co, xn, kn), shape in zip(
            probe_conv.inputs(res["batch"], res["size"]), res["shapes"]):
        if shape["rel_err"] > PROBE_REL_ERR:
            raise AssertionError(f"probe cin {cin} co {co}: kernel E against "
                                 f"the library, rel err {shape['rel_err']:.3e}"
                                 f" > {PROBE_REL_ERR:.3e}")
        x, k = torch.from_numpy(xn).cuda(), torch.from_numpy(kn).cuda()
        ref = kb.conv3x3_p1_plain(x, k)
        plain_ms, _ = cuda_ms(lambda: kb.conv3x3_p1_plain(x, k))
        # Bytes: x and y in float32 once, the weight as the kernel reads it
        # (bf16); operations at the bf16 tensor-core rate.
        flops = 2 * 9 * cin * co * x.numel() // cin
        nbytes = (x.numel() + ref.numel()) * 4 + 9 * cin * co * 2
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        for name, label in (("conv3x3_p1", "E p1"), ("conv3x3_p1_h", "E p1_h")):
            y = getattr(kb, name)(x, k)
            torch.cuda.synchronize()
            err = check_close(f"E {name} probe cin {cin} co {co}", y, ref,
                              "float32")
            row = {"shape": list(x.shape), "co": co, "dtype": "float32",
                   "compute": "bfloat16", "max_abs_err": err,
                   "tol": TOL["float32"], "rel_err_vs_library":
                   shape["rel_err"], "flops": flops,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "ms": shape["ms"][label], "plain_ms": plain_ms,
                   "library_ms": shape["ms"]["library"],
                   "kernel_b_ms": shape["ms"]["B"],
                   "tflops": shape["tflops"][label],
                   "parent_ms": parent["probe"].get(
                       (name, tuple(x.shape), co)),
                   "parent_kernel_b_ms": parent["probe_b"].get(
                       (tuple(x.shape), co))}
            rows[name].append(row)
            print(f"E {name} cin {cin} co {co}: max|diff| {err:.3e} ms "
                  f"{row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s) parent "
                  f"{fmt(row['parent_ms'])} plain {plain_ms:.4f} library "
                  f"{row['library_ms']:.4f} kernel B {row['kernel_b_ms']:.4f} "
                  f"(parent {fmt(row['parent_kernel_b_ms'])}) bound "
                  f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
        if "p1_faults" not in record:
            record["p1_faults"] = planted_faults(
                {"E x 1.01": kb.conv3x3_p1(x, k) * 1.01}, ref, "kernel E")
    out = {"launches": counts, "calls": res["calls"], "rows": rows,
           "batch": res["batch"], "size": res["size"]}
    record["probe_conv"] = out
    return out


def fmt(ms):
    return "not given" if ms is None else f"{ms:.4f}"


def load_baseline(path):
    """The parent's rows from its --out JSON (a run of the parent commit's
    chip_smoke.py in the same call), by kernel: shape keys -> ms. Empty
    without a path."""
    out = {k: {} for k in ("kernel_a", "kernel_c", "kernel_b", "kernel_b_dx",
                           "kernel_d", "probe", "probe_b")}
    if not path:
        return out
    with open(path) as f:
        rec = json.load(f)
    out["kernel_a"] = {(tuple(r["shape"]), r["dtype"]): r["ms"]
                       for r in rec["kernel_a"]}
    out["kernel_c"] = {tuple(r["shape"]): r["ms"] for r in rec["kernel_c"]
                       if r.get("dtype", "float32") == "float32"}
    for r in rec["kernel_b"]:
        out["kernel_b"][(tuple(r["shape"]), r["co"], r["dtype"],
                         r["compute"])] = r["ms"]
    for k in ("kernel_b_dx", "kernel_d"):
        out[k] = {tuple(r["shape"]): r["ms"] for r in rec[k]}
    for name, rows in rec["probe_conv"]["rows"].items():
        for r in rows:
            out["probe"][(name, tuple(r["shape"]), r["co"])] = r["ms"]
            out["probe_b"][(tuple(r["shape"]), r["co"])] = r["kernel_b_ms"]
    return out


def graph_capture(torch, ka):
    """Whether one call of kernel A and one of C (cooperative launches)
    capture into a CUDA graph and replay to the eager result, bit for bit,
    at batch 4, 256x256x64: name -> what happened. Not a gate."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    shape = (TRAIN_BATCH, FULL_RES, FULL_RES, 64)
    x = torch.randn(shape, device="cuda", generator=gen)
    g = torch.randn(shape, device="cuda", generator=gen)
    s = 1 + 0.1 * torch.randn(64, device="cuda", generator=gen)
    o = 0.1 * torch.randn(64, device="cuda", generator=gen)
    y_ref, st = ka.forward_kernel(x, s, o, "relu", 0.2)
    calls = {"A": (lambda: ka.forward_kernel(x, s, o, "relu", 0.2)[0], y_ref),
             "C": (lambda: ka.backward_kernel(x, g, st, s, o, "relu", 0.2)[0],
                   ka.backward_kernel(x, g, st, s, o, "relu", 0.2)[0])}
    out = {}
    for name, (fn, ref) in calls.items():
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # warm up off the default stream
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                y = fn()
            graph.replay()
            torch.cuda.synchronize()
            out[name] = ("captures; the replay equals the eager call"
                         if torch.equal(y, ref) else
                         "captures; the replay differs from the eager call")
        except Exception as e:  # noqa: BLE001 -- reported, not a gate
            out[name] = (f"does not capture: {type(e).__name__}: "
                         f"{str(e).strip().splitlines()[0][:200]}")
        print(f"CUDA graph capture of kernel {name}: {out[name]}", flush=True)
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
    ap.add_argument("--baseline", default=None,
                    help="the --out JSON of the parent commit's run in the "
                         "same call: its kernel A, C, B, B-dx, D and E times "
                         "are printed beside this run's")
    args = ap.parse_args()
    parent = load_baseline(args.baseline)

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
    build.build_all(["instance_norm_act", "conv3x3", "conv3x3_fwd_sm90",
                     "conv3x3_wgrad", "conv3x3_wgrad_sm90"])
    record["build_s"] = time.perf_counter() - t0
    print(f"built kernels in {record['build_s']:.1f} s", flush=True)
    record["ptxas"] = {name: build.ptxas_report(log)
                       for name, log in build.build_logs.items()}
    record["build_seconds"] = dict(build.build_seconds)
    # ptxas injects a warpgroup wait where it cannot prove that an
    # accumulator is not in use by an unfinished wgmma: each one serialises
    # the products it follows.
    record["ptxas_injected_waits"] = {
        name: log.count("warpgroup.wait is injected")
        for name, log in build.build_logs.items()}
    for name, report in record["ptxas"].items():
        print(f"  {name}.cu: nvcc {build.build_seconds[name]:.1f} s, "
              f"{record['ptxas_injected_waits'][name]} warpgroup waits "
              "injected by ptxas")
        for kernel, line in sorted(report.items()):
            print(f"  {name}: {kernel}: {line}")

    def timed(name, fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        record["phase_s"][name] = time.perf_counter() - t
        print(f"phase {name}: {record['phase_s'][name]:.1f} s", flush=True)
        return res

    timed("bench", phase_bench, torch, args, record)
    timed("edges", phase_edges, torch, ka, kb, kd, args.seed, record)
    a_rows, b_rows = timed("kernels_serving", phase_kernels, torch, ka, kb,
                           args.seed, record, parent)
    train_rows = timed("kernels_training", phase_train_kernels, torch, ka,
                       kb, kd, args.seed, record, parent)
    c_rows, dx_rows, d_rows = (train_rows[k] for k in ("c", "dx", "d"))
    train = timed("train", phase_train, torch, ka, kb, kd, args, record)
    quality = timed("quality", phase_quality, torch, ka, kb, kd, record)
    serve = timed("serve", phase_serve, torch, ka, kb, args, record)
    timed("other_widths", phase_nf, torch, ka, kb, kd, args, record)
    probe = timed("probe_conv", phase_probe, torch, ka, kb, kd, record,
                  parent)
    timed("step_card_vs_cpu", phase_step_card_vs_cpu, torch, ka, kb, args,
          record)
    timed("graph_vs_eager", phase_graph_vs_eager, torch, ka, kb, args,
          record)
    resident = timed("resident", phase_resident, torch, ka, kb, kd, args,
                     record)
    other = timed("other_generators", phase_other_generators, torch, ka, kb,
                  kd, args, record)
    variants = timed("variants", phase_variants, torch, ka, kb, kd, args,
                     record)
    parallel = timed("parallel", phase_parallel, torch, ka, kb, kd, args,
                     record)

    # Launches over the main paths: the training run, the trained folder
    # served, the quality run, and the serving runs; kernel E's in the conv
    # probe.
    launches = dict(train["launches"])
    for k in ("instance_norm_act", "conv3x3"):
        launches[k] += train["serve_launches"][k]
    # The quality run: 30 epochs trained, then served.
    for k in launches:
        launches[k] += quality["launches"][k]
    launches["instance_norm_act"] += sum(r["launches_a"] for r in serve["runs"])
    launches["conv3x3"] += sum(r["launches_b"] for r in serve["runs"])
    for k in ("conv3x3_p1", "conv3x3_p1_h"):
        launches[k] = probe["launches"][k]
    # The other generators' training runs and served folders.
    for res in other.values():
        for k in launches:
            launches[k] += (res["train"]["launches"][k]
                            + res["train"]["serve_launches"][k])
    # The variants' training runs, the served --space_to_depth folder and
    # the two-step eval.
    for k in launches:
        launches[k] += (sum(r["launches"][k]
                            for r in variants["train"].values())
                        + variants["serve_s2d"]["serve_launches"][k]
                        + variants["two_step"]["launches"][k])
    # The parallel phase's trainer runs (a) and every rank's steps of the
    # gloo runs (b) and (c), the planted faults left out.
    for k in launches:
        launches[k] += sum(parallel["nccl_ws1"][name]["launches"][k]
                           for name in ("plain", "nccl"))
        launches[k] += sum(rank[k] for name, _, _, _, fault in PAR_RUNS
                           if not fault for rank in
                           parallel["gloo"]["runs"][name]["launches"])
    # The resident phase's runs of the default and the resident step.
    for k in launches:
        launches[k] += sum(r["launches"][k]
                           for r in resident["steps"].values())
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
        kernel_entry("conv3x3", csrc + "conv3x3_fwd_sm90.cu",
                     pallas + "conv3x3.py:394",
                     launches["conv3x3"], b_step, lambda r: r["per_forward"],
                     per + ", bf16 operands", card),
        kernel_entry("conv3x3_dgrad", csrc + "conv3x3_fwd_sm90.cu",
                     pallas + "conv3x3.py:394", launches["conv3x3_dgrad"],
                     dx_rows, lambda r: r["per_step"],
                     per + ", bf16 operands", card),
        kernel_entry("conv3x3_wgrad", csrc + "conv3x3_wgrad_sm90.cu",
                     pallas + "conv3x3.py:509", launches["conv3x3_wgrad"],
                     d_rows, lambda r: r["per_step"],
                     per + ", bf16 operands", card),
    ]
    # Kernel E: its numbers summed over the three pairs of one probe pass.
    probe_per = (f"one probe pass at B{probe['batch']}, {probe['size']}\u00b2, "
                 "three (Cin, Co) pairs, float32 in and out, bf16 operands")
    for name, line in (("conv3x3_p1", 160), ("conv3x3_p1_h", 289)):
        kernels.append(kernel_entry(
            name, csrc + "conv3x3_fwd_sm90.cu", pallas + f"conv3x3.py:{line}",
            launches[name], probe["rows"][name], lambda r: 1, probe_per,
            card))
    record["kernels"] = kernels
    # B, B-dx and D a training step and E a probe pass beside cuDNN, the
    # bound and, where --baseline gives it, the parent's time.
    for key, label, rows, weight in (
            ("kernel_a_step", "A a training step", a_step,
             lambda r: r["per_forward"]),
            ("kernel_c_step", "C a training step", c_rows,
             lambda r: r["per_step"]),
            ("kernel_b_step", "B forward a training step", b_step,
             lambda r: r["per_forward"]),
            ("kernel_b_dx_step", "B-dx a training step", dx_rows,
             lambda r: r["per_step"]),
            ("kernel_d_step", "D a training step", d_rows,
             lambda r: r["per_step"]),
            ("kernel_e_pass", "E a probe pass (conv3x3_p1)",
             probe["rows"]["conv3x3_p1"], lambda r: 1),
            # The resident step's (--bf16_resident): bf16 activations.
            ("kernel_a_step_bf16", "A a resident training step",
             train_rows["a_bf16"], lambda r: r["per_step"]),
            ("kernel_c_step_bf16", "C a resident training step",
             train_rows["c_bf16"], lambda r: r["per_step"]),
            ("kernel_b_step_bf16", "B forward a resident training step",
             [r for r in b_rows if r["shape"][0] == TRAIN_BATCH
              and r["dtype"] == r["compute"] == "bfloat16"],
             lambda r: r["per_forward"]),
            ("kernel_b_dx_step_bf16", "B-dx a resident training step",
             train_rows["dx_bf16"], lambda r: r["per_step"]),
            ("kernel_d_step_bf16", "D a resident training step",
             train_rows["d_bf16"], lambda r: r["per_step"])):
        total = {k: sum(r[k] * weight(r) for r in rows)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        if all(r.get("parent_ms") is not None for r in rows):
            total["parent_ms"] = sum(r["parent_ms"] * weight(r) for r in rows)
        record[key] = total
        print(f"{label}: {total['ms']:.4f} ms (parent "
              f"{fmt(total.get('parent_ms'))}, plain "
              f"{total['plain_ms']:.4f}, library "
              f"{total['library_ms']:.4f}, bound {total['bound_ms']:.4f})",
              flush=True)
    record["main_path_launches"] = launches
    record["graph_capture"] = graph_capture(torch, ka)
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
