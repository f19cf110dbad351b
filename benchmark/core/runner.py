"""A run of one cell, from set-up to the result line.

``run`` measures the window (``cell.py``), reads the per-layer metrics
from the trace with the readers under ``metrics/`` (``--trace 1``), frees
the program, then follows the first steps with the reference on the same
device and decides ``correct``. The result is one JSON object:
``correct``, ``attempted`` (training images in the window), ``failed``
(all of them where an epoch's mean losses are not finite), ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, ``readings`` (numbers read
and not compared) and last ``checks``: each compared number with its
limit.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Tuple

import torch

from benchmark.core.cell import TrainRun, Window
from benchmark.core.check import REPORTED, check_lines, checks, gaps, verdict
from benchmark.core.spec import Cell, readers
from benchmark.reference.follow import follow

BANNED = ("jax", "jaxlib", "flax", "tactile_gan_tpu")


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the traced window and the cell."""
    window: Window
    config: dict
    traffic: dict

    @property
    def trace(self):
        return self.window.trace


def banned_modules(names=None) -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of ``BANNED``, compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def run(root: str, cell: Cell, seed: int, seconds: float, trace: bool,
        device: str, t_start: float) -> Tuple[dict, List[str]]:
    """Returns (the result object, the check lines)."""
    tr = TrainRun(cell, seed, device, t_start, seconds, trace)
    try:
        tr.setup()
        win = tr.measure()
        metrics: Dict[str, dict] = {}
        out = {}
        if trace:
            reading = Reading(win, cell.config, cell.traffic)
            for m, reader in readers(root, cell).items():
                value = reader.read(reading)
                if value is not None:
                    unit = next(x["unit"] for x in cell.per_layer
                                if x["name"] == m)
                    metrics[m] = {"value": value, "unit": unit}
            if win.trace is not None:
                out["breakdown"] = win.trace.breakdown()
        else:
            e2e = {"train_img_per_s": win.images / win.seconds,
                   "setup_s": win.setup_s}
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        info = device_info(tr.device, win.memory_peak_bytes)
        if trace and win.trace is not None:
            info["busy_s"] = win.trace.busy_s()
            info["window_s"] = win.trace.window_s
        prog = tr.readings
        tr.release()
        ref = follow(cell.config, cell.traffic, seed, tr.img_dir(),
                     tr.device, at=prog.at)
    finally:
        tr.remove_data()
    values = gaps(prog, ref, cell.config["lambda_a"])
    limits = cell.limits
    correct = verdict(values, limits) and win.nonfinite_epochs == 0
    failed = win.images if win.nonfinite_epochs else 0
    result = {"correct": correct, "attempted": win.images, "failed": failed,
              "metrics": metrics, "device": info}
    result.update(out)
    result["readings"] = {k: values[k] for k in REPORTED}
    result["phases"] = tr.phases
    result["checks"] = checks(values, limits)
    return result, check_lines(values, limits)
