"""The metric arithmetic: interval union, idle share, kernel families,
the breakdown, the work counts of both rooflines, step_mfu, and readers
that find nothing to read."""

import json
import math
import os

import pytest

from benchmark.core.runner import Reading
from benchmark.core.cell import Window
from benchmark.core.spec import load_reader
from benchmark.core.trace import (
    HBM_BYTES_PER_S, PEAK_FLOPS, Trace, idle_gaps, kernel_family,
    union_length,
)
from benchmark.tests.conftest import ROOT


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name)) as f:
        return json.load(f)


def _traffic(name):
    with open(os.path.join(ROOT, "benchmark", "traffic", name)) as f:
        return json.load(f)


def _reading(trace, steps=10, seconds=2.0, waits=None, config=None,
             traffic=None):
    win = Window(seconds=seconds, steps=steps, images=4 * steps, setup_s=1.0,
                 data_wait_s=waits or [0.001] * steps,
                 memory_peak_bytes=0, nonfinite_epochs=0, trace=trace)
    return Reading(win, config or _config("unetpp-nf64.json"),
                   traffic or _traffic("b4-v1.json"))


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 6.5)]
    assert union_length(spans) == pytest.approx(3.5)
    assert idle_gaps(spans) == [(4.0, 6.0), (2.0, 3.0)]
    assert union_length([]) == 0.0


def test_idle_share():
    trace = Trace([("k", 0.0, 0.25), ("k", 0.5, 1.0), ("k", 0.75, 0.9)], [],
                  window_s=1.0, steps=1)
    reader = load_reader(ROOT, "device_idle_share")
    assert reader.read(_reading(trace)) == pytest.approx(25.0)
    assert reader.read(_reading(None)) is None


def test_families_match_own_kernels_first():
    assert kernel_family("void (anonymous namespace)::in_act_fwd_kernel"
                         "<float>(Args)") == "kernel_a"
    # An own kernel whose name holds a library substring ("conv").
    assert kernel_family("void conv3x3_dgrad_sm90_kernel<float, 64>()") \
        == "kernel_b_dx"
    assert kernel_family("wgrad_reduce_kernel") == "kernel_d"
    assert kernel_family("sm80_xmma_fprop_implicit_gemm_indexed_bf16")\
        == "library_conv"
    assert kernel_family("void at::native::vectorized_elementwise_kernel")\
        == "other"
    # Whole identifiers: a longer name that contains an own kernel's is not
    # that kernel.
    assert kernel_family("my_in_act_fwd_kernel_v2") == "other"


def test_ms_per_step_and_breakdown():
    ops = [("in_act_fwd_kernel", 0.0, 0.001), ("in_act_bwd_kernel", 0.002,
                                                0.004),
           ("cudnn_conv", 0.004, 0.010), ("elementwise", 0.020, 0.021)]
    trace = Trace(ops, [("bench.data_wait", 0.0105, 0.0195),
                        ("outer", 0.0, 0.03)], window_s=0.03, steps=2)
    assert trace.ms_per_step(["kernel_a", "kernel_c"]) == pytest.approx(1.5)
    assert trace.ms_per_step(["kernel_b"]) is None
    assert load_reader(ROOT, "library_conv_ms").read(_reading(trace, 2)) \
        == pytest.approx(3.0)
    assert load_reader(ROOT, "other_ms").read(_reading(trace, 2)) \
        == pytest.approx(0.5)
    b = trace.breakdown()
    assert b["device_ops"][0] == ["cudnn_conv", pytest.approx(0.006)]
    # The longest gap (0.010-0.020) lies inside the harness's data wait,
    # the innermost host span covering it.
    assert b["idle_gaps"][0] == ["bench.data_wait", pytest.approx(0.010)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_norm_roofline_bytes_at_unetpp_shapes():
    from benchmark.metrics import norm_roofline
    from benchmark.reference.flops import generator_norm_shapes

    config = _config("unetpp-nf64.json")
    shapes = generator_norm_shapes(config, 4)
    assert len(shapes) == 30  # two norms in each of the 15 nodes
    widths = sorted({s[1] for s in shapes})
    assert widths == [64, 128, 256, 512, 1024]
    elems = sum(math.prod(s) for s in shapes)
    # A forward reads x and writes y, a backward reads x and g and writes
    # dx: five float32 passes over every norm's input.
    assert norm_roofline.bound_s(config, 4) == pytest.approx(
        5 * 4 * elems / HBM_BYTES_PER_S)
    # chip_smoke.py's bounds for a step's 30 A and 30 C launches at batch 4.
    assert norm_roofline.bound_s(config, 4) * 1e3 == pytest.approx(
        0.646 + 0.969, abs=2e-3)
    unet = generator_norm_shapes(_config("unet-nf64.json"), 4)
    assert len(unet) == 28


def test_norm_roofline_share():
    reader = load_reader(ROOT, "norm_roofline")
    config = _config("unetpp-nf64.json")
    bound = reader.bound_s(config, 4)
    trace = Trace([("in_act_fwd_kernel", 0.0, bound),
                   ("in_act_bwd_kernel", 1.0, 1.0 + bound)], [],
                  window_s=2.0, steps=1)
    # Twice the bound's time in all: 50 %.
    assert reader.read(_reading(trace, steps=1)) == pytest.approx(50.0)
    assert reader.read(_reading(Trace([], [], 1.0, 1))) is None


def test_row0_conv_roofline():
    reader = load_reader(ROOT, "row0_conv_roofline")
    config = _config("unetpp-nf64.json")
    convs = reader.row0_convs(config)
    assert len(convs) == 9
    assert convs[0] == (64, 64) and convs[1] == (192, 64)
    bound = reader.bound_s(config, 4)
    pixels = 4 * 256 * 256
    # Every one of the 27 passes is bound by its bytes at these widths.
    want = sum(((pixels * ci + pixels * co) * 4 + 9 * ci * co * w)
               / HBM_BYTES_PER_S for ci, co in convs for w in (2, 2, 4))
    assert bound == pytest.approx(want)
    assert all(2 * pixels * ci * co * 9 / PEAK_FLOPS
               < (pixels * ci + pixels * co) * 4 / HBM_BYTES_PER_S
               for ci, co in convs)
    trace = Trace([("conv3x3_fwd_sm90_kernel", 0.0, bound / 2),
                   ("conv3x3_dgrad_sm90_kernel", 1.0, 1.0 + bound / 2),
                   ("wgrad_reduce_kernel", 2.0, 2.0 + bound)], [], 3.0, 1)
    assert reader.read(_reading(trace, steps=1)) == pytest.approx(50.0)
    # UNet runs no row 0: the reader finds nothing.
    assert reader.read(_reading(trace, config=_config("unet-nf64.json"))) \
        is None


def test_step_mfu_and_flop_count():
    from benchmark.reference.flops import step_flops

    config = _config("unetpp-nf64.json")
    bench = dict(_traffic("b4-v1.json"), lambda_per=0.0)
    # bench.py's configuration (perceptual loss off) counted 3.930 TFLOP a
    # step with FlopCounterMode over the port's eager step.
    assert step_flops(config, bench) / 1e12 == pytest.approx(3.9296, abs=1e-3)
    traffic = _traffic("b4-v1.json")
    flops = step_flops(config, traffic)
    reading = _reading(None, steps=50, seconds=2.5, traffic=traffic)
    assert load_reader(ROOT, "step_mfu").read(reading) == pytest.approx(
        flops * 50 / 2.5 / PEAK_FLOPS * 100)


def test_data_wait_ms():
    reader = load_reader(ROOT, "data_wait_ms")
    reading = _reading(None, steps=4, waits=[0.001, 0.002, 0.003, 0.006])
    assert reader.read(reading) == pytest.approx(3.0)
    assert reader.read(_reading(None, steps=0, waits=[])) is None
