"""The benchmark of the PyTorch and CUDA port (``tactile_gan_torch``): one
run of one cell.

    python3 benchmark/run.py --workload train.unetpp.b4 --seed 7 \
        --seconds 10 --trace 0

Run from the checkout's root on a machine with the card(s) the cell asks
for. Builds the cell from the seed (charts, weights), warms it up, trains
through the port's ``Trainer`` for ``--seconds``, checks the first steps
against the plain reference and prints one JSON object as the last line of
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (the window under ``torch.profiler``).
Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result. The compared numbers and their limits are the last lines
of standard error and the ``checks`` key of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Python's bytecode, cached at a fixed path inside the checkout: a machine
# whose installed packages carry no valid .pyc compiles them anew in every
# run (some 5 s of set-up). The port's nvcc libraries go to
# tactile_gan_torch/_build/ in the checkout on their own.
PYCACHE = ".bench_cache/pycache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.pycache_prefix = os.path.join(ROOT, PYCACHE)
    sys.dont_write_bytecode = False
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from benchmark.core.runner import banned_modules, run
    from benchmark.core.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run(ROOT, cell, args.seed, args.seconds,
                        bool(args.trace), "cuda", T_START)
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   result.pop("phases").items()),
          file=sys.stderr)
    found = banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
