"""Tiny cells for the CPU tests: every cell of ``BENCHMARK.json`` at nf 8
and its generator's ``CPU_TEST_SIZE`` (the smallest square image its
stages take), 8 chart pairs, batch 2, float32 compute (so that the
program and the reference agree to rounding), on the CPU."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    WORKLOADS = tuple(w["name"] for w in json.load(_f)["workloads"])


def shrink(cell, compute_dtype="float32"):
    from benchmark.reference.networks import find

    size = find(cell.config["gen"], "gen").cpu_test_size
    cell.config.update(nf=8, compute_dtype=compute_dtype, image_size=size)
    cell.traffic.update(pairs=8, batch_size=2, threads=2)
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark.core.spec import load_cell

    def make(workload, compute_dtype="float32"):
        return shrink(load_cell(ROOT, workload), compute_dtype)
    return make


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
