"""Quality run: ``python -m tactile_gan_torch.cli.quality [--batch 4]
[--version 2] [--lambda_per L]``.

The port's counterpart of ``scripts/quality_run.sh``: writes the synthetic
chart set (96 training and 16 test pairs at 256x256, seed 0) under
``{work}/data`` unless it is there (a set there that ``synth.json`` does
not show to be this run's is refused), trains UNet++ nf 64 for 30 epochs
with the script's training flags through ``cli.train``, serves the test pairs
through ``cli.test`` at its defaults, prints ``eval.txt`` as the script's
``cat`` does and then one JSON line: the config and seed, the mean Dice,
accuracy and Jaccard, the L1 curve (``l1loss.npy``), the training seconds
(epoch 1, which holds the CUDA graph captures, apart), the serving seconds,
the kernel launches a training step (by wrapper, as ``train/graph.py``'s
``LAUNCH_COUNTERS`` names them; all, and those on bfloat16 activations)
and the device. Each flag maps one of
the script's environment knobs, with its default (``--work`` under the
temporary directory, ``$TMPDIR`` or ``/tmp``); ``--seed``,
``--device``, ``--bf16_resident`` and ``--disc_bf16`` are the port's. The
last two pass on to ``cli.train``: on a TPU the script's run takes both
modes from the JAX package's auto gate, which the port never engages, so
they run the configuration of the JAX record. The script's three record
configs:

    python -m tactile_gan_torch.cli.quality --batch 4 --version 2
    python -m tactile_gan_torch.cli.quality --batch 16 --version 2
    python -m tactile_gan_torch.cli.quality --batch 4 --version 1 --lambda_per 1

each with ``--bf16_resident --disc_bf16`` for the JAX record's dtypes.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

# The script's sizes: make_synth_dataset.py's 256x256 charts, 96 + 16 pairs.
SIZE, N_TRAIN, N_TEST = 256, 96, 16
DATA_SEED = 0  # make_synth_dataset.py's default
STAMP = "synth.json"  # beside the chart set: what it was written with

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4,
                   help="training batch size (the script's BATCH)")
    p.add_argument("--version", type=int, default=2, choices=[1, 2],
                   help="loss version (the script's VERSION)")
    p.add_argument("--epochs", type=int, default=30,
                   help="training epochs (the script's EPOCHS)")
    p.add_argument("--lambda_per", type=float, default=None,
                   help="--lambda_per override (the script's LAMBDA_PER; "
                        "unset = cli.train's default)")
    p.add_argument("--tag", default=None,
                   help="model folder (the script's TAG; default "
                        "quality_b{batch}_v{version}, with _resident "
                        "after it under either residency flag)")
    p.add_argument("--work",
                   default=os.path.join(tempfile.gettempdir(), "quality_run"),
                   help="work root holding data/, models/ and Outputs/ "
                        "(the script's WORK)")
    p.add_argument("--seed", type=int, default=21, help="training seed")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--bf16_resident", default=False, action="store_true",
                   help="train with cli.train's --bf16_resident")
    p.add_argument("--disc_bf16", default=False, action="store_true",
                   help="train with cli.train's --disc_bf16")
    args = p.parse_args(argv)
    if args.tag is None:
        args.tag = f"quality_b{args.batch}_v{args.version}" + (
            "_resident" if args.bf16_resident or args.disc_bf16 else "")
    return args


def train_argv(args: argparse.Namespace, *, nf: int = 64,
               size: int = SIZE) -> list:
    """``cli.train``'s argv: the script's ``python train.py`` flags in its
    order, then ``--image_size`` where ``size`` is not the script's, the
    residency flags given, then the seed and the device."""
    argv = ["--data", os.path.join(args.work, "data"), "--gen", "UNet++",
            "--nf", str(nf), "--batch_size", str(args.batch),
            "--total_epochs", str(args.epochs), "--epoch_constant", "10",
            "--version", str(args.version), "--lambda_gp", "0.01",
            "--folder_save", args.tag, "--folder_load", args.tag]
    if args.lambda_per is not None:
        argv += ["--lambda_per", f"{args.lambda_per:g}"]
    if size != SIZE:
        argv += ["--image_size", str(size)]
    argv += [f"--{flag}" for flag in ("bf16_resident", "disc_bf16")
             if getattr(args, flag)]
    return argv + ["--seed", str(args.seed), "--device", args.device]


def serve_argv(args: argparse.Namespace) -> list:
    """``cli.test``'s argv: the script's ``python test.py`` flags, then the
    device."""
    return ["--folder", args.tag, "--work_root", args.work,
            "--device", args.device]


def chart_set(data: str, n_train: int, n_test: int, size: int) -> None:
    """Write the chart set under ``data`` unless it is there; refuse one
    there whose ``synth.json`` is missing or names other sizes or counts."""
    from tactile_gan_torch.data import synth

    want = {"n_train": n_train, "n_test": n_test, "size": size,
            "seed": DATA_SEED}
    stamp = os.path.join(data, STAMP)
    if not os.path.isdir(os.path.join(data, "train", "source")):
        synth.write_dataset(data, n_train, n_test, size, seed=DATA_SEED)
        with open(stamp, "w") as f:
            json.dump(want, f)
        return
    have = None
    if os.path.exists(stamp):
        with open(stamp) as f:
            have = json.load(f)
    if have != want:
        raise ValueError(f"{data} holds a chart set written with {have}, "
                         f"not {want}: remove it or pass another --work")


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    from tactile_gan_torch.utils.profiling import card_line

    return card_line().splitlines()[0]


def main(argv=None, *, nf: int = 64, size: int = SIZE, n_train: int = N_TRAIN,
         n_test: int = N_TEST) -> dict:
    """Run the quality flow; returns the JSON line's dict. ``nf``, ``size``,
    ``n_train`` and ``n_test`` (test hooks, not flags) shrink the run."""
    from tactile_gan_torch.cli import test as test_cli
    from tactile_gan_torch.cli import train as train_cli
    from tactile_gan_torch.core.device import resolve_device
    from tactile_gan_torch.train.graph import LAUNCH_COUNTERS, read_launches

    args = parse_args(argv)
    device = resolve_device(args.device)  # no card: raises before any work
    chart_set(os.path.join(args.work, "data"), n_train, n_test, size)

    counts = ("launches", "bf16_launches")
    before = [read_launches(c) for c in counts]
    trainer = train_cli.main(train_argv(args, nf=nf, size=size))
    steps = trainer.state.step
    launches, bf16 = ({name: (after - b) / steps for (_, name), after, b in
                       zip(LAUNCH_COUNTERS, read_launches(c), bc)}
                      for c, bc in zip(counts, before))
    t0 = time.perf_counter()
    metrics = test_cli.main(serve_argv(args))
    eval_s = time.perf_counter() - t0

    out_dir = os.path.join(args.work, "Outputs", args.tag)
    with open(os.path.join(out_dir, "eval.txt")) as f:
        print(f.read(), end="")
    l1 = np.load(os.path.join(trainer.cfg.models_dir(), "l1loss.npy"))
    epoch_s = trainer.epoch_seconds
    result = {
        "config": {"batch": args.batch, "version": args.version,
                   "epochs": args.epochs, "lambda_per": args.lambda_per,
                   "tag": args.tag, "nf": nf, "size": size,
                   "n_train": n_train, "n_test": n_test},
        "seed": args.seed,
        "bf16_resident": trainer.cfg.effective_bf16_resident(),
        "disc_bf16": trainer.cfg.effective_disc_bf16(),
        **metrics,
        "l1_first": float(l1[0]), "l1_last": float(l1[-1]),
        "l1_curve": [float(v) for v in l1],
        "train_s": sum(epoch_s),
        "epoch1_s": epoch_s[0],
        "s_per_epoch": (float(np.mean(epoch_s[1:])) if len(epoch_s) > 1
                        else None),
        "steps": steps,
        "eval_s": eval_s,
        "launches_per_step": launches,
        "bf16_launches_per_step": bf16,
        "device": device_name(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
