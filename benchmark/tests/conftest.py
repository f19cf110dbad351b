"""Tiny cells for the CPU tests: the benchmark's own cells at nf 8, 64 px
(UNet: 256 px, which its seven stride-2 stages need), 8 chart pairs,
batch 2, float32 compute (so that the program and the reference agree to
rounding), on the CPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

WORKLOADS = ("train.unetpp.b4", "train.unet.b4", "train.unetpp.b4v2")


def shrink(cell, compute_dtype="float32"):
    cell.config.update(nf=8, compute_dtype=compute_dtype,
                       image_size=256 if cell.config["gen"] == "UNet" else 64)
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
