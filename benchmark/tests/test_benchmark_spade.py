"""The SPADE cell (``train.spade.b4``): the output check fails the control
on it at a tiny size on the CPU, its work counts and weights are pinned,
every norm its reference records runs on the port's kernel A (C in the
backward), and ``spade_ms`` walks the layers' marks on synthetic traces,
reading None where no mark ran (the parent's program, another
generator)."""

import hashlib
import json
import math
import os
import shutil
import tempfile

import pytest
import torch

from benchmark.core.check import gaps, verdict
from benchmark.core.spec import load_cell, load_reader
from benchmark.core.trace import LIBRARY_CONV, Trace, kernel_family
from benchmark.core.weights import network_weights
from benchmark.reference.flops import generator_norm_shapes, step_flops
from benchmark.reference.follow import follow, networks
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_benchmark_metrics import _config, _reading
from benchmark.traffic_gen.synth import write_dataset

CELL = "train.spade.b4"
SEED = 2 ** 31 + 23
MARKS = ("tg_mark_spade_in", "tg_mark_spade_out", "tg_mark_spade_bwd_out",
         "tg_mark_spade_bwd_in")


def test_control_is_not_correct(tiny_cell):
    """The reference with its G and D convs in float8 (one precision below
    the configuration's bfloat16) in the program's place fails the cell's
    limits, G's step-2 gradient among them."""
    cell = tiny_cell(CELL)
    d = tempfile.mkdtemp()
    try:
        write_dataset(os.path.join(d, "data"), n_train=8, n_test=0,
                      size=cell.config["image_size"], seed=SEED)
        img = os.path.join(d, "data", "train", "source")
        control = follow(cell.config, cell.traffic, SEED, img, "cpu",
                         prec="fp8")
        ref = follow(cell.config, cell.traffic, SEED, img, "cpu",
                     at=control.at)
    finally:
        shutil.rmtree(d)
    values = gaps(control, ref, cell.config["lambda_a"])
    assert not verdict(values, cell.limits), values
    # G's path, the SPADE layers' included, seen entry by entry.
    assert values["gen_grad_error"] > cell.limits["gen_grad_error"]


# Read off this cell's reference: the step's FLOPs, the generator's norm
# shapes at batch 4 (count, elements, sha256 of the list) and a sha256 of
# G's weights made from seed 1 on the CPU.
PINNED_FLOPS = 4222594111488
PINNED_NORMS = (18, 162004992, "115f29142b127b87d95eeff2be4d31d0"
                "843cdb9511792991830a0a41470c1435")
PINNED_WEIGHTS = ("d507c6e7107bc51ebe3cd5edb1b80898"
                  "1a207f8a030120d207b16347682fdfc5")


def test_step_flops_pinned():
    cell = load_cell(ROOT, CELL)
    assert step_flops(cell.config, cell.traffic) == PINNED_FLOPS


def test_norm_shapes_pinned():
    shapes = generator_norm_shapes(load_cell(ROOT, CELL).config, 4)
    digest = hashlib.sha256(json.dumps([list(s) for s in shapes]).encode())
    assert (len(shapes), sum(math.prod(s) for s in shapes),
            digest.hexdigest()) == PINNED_NORMS


def test_weights_pinned():
    config = load_cell(ROOT, CELL).config
    gen = networks(config, "f32", "meta")[0]
    assert sum(p.numel() for p in gen.parameters()) == \
        config["counted"]["generator_parameters"]
    weights = network_weights(gen, 1, "gen", "cpu")
    h = hashlib.sha256()
    for name in sorted(weights):
        h.update(name.encode())
        h.update(weights[name].contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED_WEIGHTS


def test_every_recorded_norm_runs_on_kernel_a(tiny_cell, monkeypatch):
    """``norm_roofline`` bounds the norms the reference records and times
    kernels A and C: the port's forward calls the norm + activation
    Function (kernel A on the card, C in its backward) once for each, at
    the same shape, and no other norm."""
    from tactile_gan_torch.models.factory import create_generator
    from tactile_gan_torch.ops.kernels import instance_norm

    config = tiny_cell(CELL).config
    size = config["image_size"]
    want = [tuple(s) for s in generator_norm_shapes(config, 2)]
    seen = []
    apply = instance_norm.InstanceNormAct.apply

    def record(x, *a):
        n, h, w, c = x.shape
        seen.append((n, c, h, w))
        return apply(x, *a)
    monkeypatch.setattr(instance_norm.InstanceNormAct, "apply", record)
    gen = create_generator(config["gen"], nf=config["nf"])
    with torch.no_grad():
        gen(torch.zeros(2, size, size, config["input_dim"]))
    assert seen == want and len(seen) == 18


def _layer(t, ms):
    """One SPADE layer's forward at ``t`` (s): entry mark, a kernel of
    ``ms`` ms, exit mark; returns the ops and the end."""
    k = ms * 1e-3
    return [("tg_mark_spade_in", t, t + 1e-6),
            ("in_act_fwd_kernel", t + 2e-6, t + 2e-6 + k),
            ("tg_mark_spade_out", t + 3e-6 + k, t + 4e-6 + k)], t + 5e-6 + k


def _backward(t, ms):
    k = ms * 1e-3
    return [("tg_mark_spade_bwd_out", t, t + 1e-6),
            ("in_act_bwd_kernel", t + 2e-6, t + 2e-6 + k),
            ("tg_mark_spade_bwd_in", t + 3e-6 + k, t + 4e-6 + k)], \
        t + 5e-6 + k


def _trace():
    """Two steps: each a kernel outside any layer, two layers' forwards
    (0.5 and 1.5 ms), the trunk's conv after each (outside), and their
    backwards (3.0 and 1.0 ms); a copy of the prefetcher's, inside a layer
    in time, on its own stream."""
    ops, t = [], 0.0
    for _ in range(2):
        ops.append(("tg_mark_g_fwd", t, t + 1e-6))
        ops.append(("conv_outside", t + 2e-6, t + 0.002))
        t += 0.003
        for ms in (0.5, 1.5):
            layer, t = _layer(t, ms)
            ops += layer
            ops.append(("trunk_conv", t, t + 0.001))
            t += 0.0011
        ops.append(("tg_mark_g_bwd", t, t + 1e-6))
        t += 2e-6
        for ms in (3.0, 1.0):
            layer, t = _backward(t, ms)
            ops += layer
        t += 0.01
    ops.append(("Memcpy HtoD (Pinned -> Device)", 0.0032, 0.0035))
    return Trace(ops, [], window_s=t, steps=2)


def _read(trace):
    return load_reader(ROOT, "spade_ms").read(
        _reading(trace, steps=trace.steps,
                 config=_config("spade-ngf64.json")))


def test_spade_ms_sums_the_layers():
    assert _read(_trace()) == pytest.approx(0.5 + 1.5 + 3.0 + 1.0)


def test_spade_ms_a_lost_mark_costs_one_span():
    """A trace that lost a layer's closing mark counts on to the next
    closing mark, not to the window's end; one that lost an opening mark
    misses that layer alone."""
    ops = [("tg_mark_spade_bwd_out", 0.0, 1e-6),
           ("k", 1e-5, 0.001),  # the lost closing mark's layer: 1 ms
           ("between_layers", 0.0011, 0.0021),  # counted: 1 ms
           ("tg_mark_spade_bwd_out", 0.0022, 0.0022001),
           ("k", 0.0023, 0.0033),
           ("tg_mark_spade_bwd_in", 0.0034, 0.0034001),
           ("after", 0.0036, 0.0136),  # not counted
           ("k", 0.014, 0.015),  # its opening mark lost: not counted
           ("tg_mark_spade_bwd_in", 0.0151, 0.0152)]
    assert _read(Trace(ops, [], window_s=0.02, steps=1)) == \
        pytest.approx(0.99 + 1.0 + 1.0)


def test_spade_ms_counts_side_by_side_work_once():
    """Operations that overlap inside a layer count once, and an operation
    that runs past the closing mark counts up to it: the metric is the
    device's busy time inside the layers' windows."""
    ops = [("tg_mark_spade_bwd_out", 0.0, 1e-6),
           ("dgrad", 0.0001, 0.0011),
           ("bias_sum", 0.0006, 0.0016),  # beside the dgrad: 0.5 ms more
           ("wgrad", 0.0018, 0.0038),  # past the closing mark: 1 ms of it
           ("tg_mark_spade_bwd_in", 0.0028, 0.0028001),
           ("after", 0.004, 0.005)]
    assert _read(Trace(ops, [], window_s=0.01, steps=1)) == \
        pytest.approx(1.5 + 1.0)


def test_spade_ms_windows_of_marks_out_of_order():
    """Where two layers' marks arrive out of turn (two closing marks, then
    two opening marks), a window runs from the first opening mark to the
    next closing mark, and the marks in between open or close nothing."""
    from benchmark.metrics.spade_ms import windows
    marks = [("tg_mark_spade_bwd_out", 0.0, 0.1),
             ("tg_mark_spade_bwd_in", 1.0, 1.1),
             ("tg_mark_spade_bwd_in", 2.0, 2.1),
             ("tg_mark_spade_bwd_out", 3.0, 3.1),
             ("tg_mark_spade_bwd_out", 4.0, 4.1),
             ("k", 4.5, 4.6),
             ("tg_mark_spade_bwd_in", 5.0, 5.1)]
    assert windows(marks) == [(0.1, 1.0), (3.1, 5.0)]


def test_spade_ms_reads_none_without_marks():
    """The parent's program, another generator's trace, no trace, a CPU
    run's trace: None."""
    bare = Trace([op for op in _trace().device_ops
                  if op[0] not in MARKS], [], window_s=0.1, steps=2)
    assert _read(bare) is None
    assert load_reader(ROOT, "spade_ms").read(_reading(None)) is None
    assert _read(Trace([], [], window_s=0.1, steps=2)) is None


def test_layer_marks_are_other_kernels():
    """No mark counts as a library conv or one of the port's own kernels,
    and none is a phase's: the families and the phases read as before."""
    from benchmark.core.phases import END_MARK, MARKS as PHASE_MARKS

    for name in MARKS:
        assert kernel_family(name) == "other"
        assert not any(k in name for k in LIBRARY_CONV)
        assert name not in PHASE_MARKS and name != END_MARK
