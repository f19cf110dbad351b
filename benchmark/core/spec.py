"""Finds a cell's pieces by name, as data.

``BENCHMARK.json`` (at the checkout's root) lists the cells; each names a
configuration and a traffic mix. The pieces are files of their own:

- a configuration: the ``file`` its entry names (``benchmark/configs/``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- the limits of a cell's output check: ``benchmark/limits/<cell>.json``;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, a reader with
  ``read(reading) -> float | None``;
- a configuration's reference networks: the modules of
  ``benchmark/reference/networks/`` whose ``NAME`` is the configuration's
  ``gen`` or ``disc`` (``reference/networks/__init__.py``).

A later cell, mix, configuration, metric or reference network is one more
file (and, but for a network, one more entry in ``BENCHMARK.json``):
nothing here names any of them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = "benchmark"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its pieces."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _load_json(os.path.join(root, BENCH_DIR, "traffic",
                                      f"{entry['traffic']}.json"))
    limits = _load_json(os.path.join(root, BENCH_DIR, "limits",
                                     f"{workload}.json"))
    return Cell(workload, entry["chips"], config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)])


def load_reader(root: str, metric: str):
    """The module of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def readers(root: str, cell: Cell) -> Dict[str, object]:
    return {m["name"]: load_reader(root, m["name"]) for m in cell.per_layer}
