"""Readings that the limits of the output check are set from, for one or
more cells, in one process (set-up is long; the kernels load once):

- ``--program-seeds``: the program as a run drives it (set-up, the warm-up
  epoch through the trainer, a window of one step), against the
  reference: the lower readings;
- ``--resident-seeds``: the same, with the program's own lower-precision
  path switched on (``bf16_resident`` and ``disc_bf16``: bfloat16
  activations between the ops), against the float32 reference of the
  configuration as it stands;
- ``--control-seeds``: the reference put in the program's place, with its
  G and D convs in float8 (the control, one precision below the
  configuration's bf16), with G's convs' backward alone in float8, in
  bfloat16 (a witness: the configuration's own precision), with G's
  forward in bfloat16 and its backward in float32 (a witness: what the
  forward's rounding alone does to G's gradient), and in float32
  with a planted fault (the step on half of each batch; a step that leaves
  its state unchanged), each against the float32 reference (step 2's
  gradients taken at the control's own state): the upper readings.

    python3 benchmark/calibrate.py --workload train.unetpp.b4 \
        --program-seeds 1 2 3 --resident-seeds 7 8 9 \
        --control-seeds 4 5 6 --out calib.jsonl

Needs a CUDA card. Prints one JSON line a reading; the benchmark's own runs
never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROLS = (("fp8", "fp8", ""), ("fp8_gbwd", "fp8_gbwd", ""),
            ("bf16", "bf16", ""), ("bf16_gfwd", "bf16_gfwd", ""),
            ("half_batch", "f32", "half_batch"),
            ("unchanged", "f32", "unchanged"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", nargs="+", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--resident-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import dataclasses
    import shutil

    import torch

    from benchmark.core.cell import TrainRun
    from benchmark.core.check import _error, gaps, objectives
    from benchmark.core.spec import load_cell
    from benchmark.reference.follow import follow
    from benchmark.traffic_gen.synth import write_dataset

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def detail(prog, ref, lam):
        po, ro = objectives(prog.losses, lam), objectives(ref.losses, lam)
        return {"objective_gaps": (abs(po - ro) / abs(ro)).tolist(),
                "loss_gaps": (abs(prog.losses - ref.losses)
                              / abs(ref.losses)).tolist(),
                "losses": prog.losses.tolist(),
                "ref_losses": ref.losses.tolist(),
                "grad_norms": prog.grad_norms,
                "ref_grad_norms": ref.grad_norms,
                "change_norms": prog.change_norms,
                "ref_change_norms": ref.change_norms,
                "replay_leaves": {  # leaf -> [its error, |reference|]
                    net: {k: [_error({k: prog.replay_grads[net][k]},
                                     {k: g}),
                              float(g.double().norm())]
                          for k, g in r.items()}
                    for net, r in ref.replay_grads.items()}}

    for wl in args.workload:
        cell = load_cell(ROOT, wl)
        lam = cell.config["lambda_a"]
        resident = dataclasses.replace(cell, config=dict(
            cell.config, bf16_resident=True, disc_bf16=True))
        for side, run_cell, seeds in (("program", cell, args.program_seeds),
                                      ("resident", resident,
                                       args.resident_seeds)):
            for seed in seeds:
                t = time.perf_counter()
                tr = TrainRun(run_cell, seed, "cuda", t, 0.0, False)
                try:
                    tr.setup()
                    tr.measure()
                    prog = tr.readings
                    tr.release()
                    ref = follow(cell.config, cell.traffic, seed,
                                 tr.img_dir(), tr.device, at=prog.at)
                finally:
                    tr.remove_data()
                emit({"workload": wl, "seed": seed, "side": side,
                      **gaps(prog, ref, lam), **detail(prog, ref, lam),
                      "seconds": time.perf_counter() - t})
        for seed in args.control_seeds:
            d = tempfile.mkdtemp(prefix="bench_calib_")
            try:
                write_dataset(os.path.join(d, "data"),
                              n_train=cell.traffic["pairs"], n_test=0,
                              size=cell.config["image_size"], seed=seed)
                img = os.path.join(d, "data", "train", "source")
                for side, prec, fault in CONTROLS:
                    t = time.perf_counter()
                    got = follow(cell.config, cell.traffic, seed, img,
                                 "cuda", prec=prec, fault=fault)
                    ref = follow(cell.config, cell.traffic, seed, img,
                                 "cuda", at=got.at)
                    emit({"workload": wl, "seed": seed, "side": side,
                          **gaps(got, ref, lam), **detail(got, ref, lam),
                          "seconds": time.perf_counter() - t})
            finally:
                shutil.rmtree(d, ignore_errors=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
