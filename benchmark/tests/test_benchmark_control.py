"""The output check fails what it must, on the CPU at a tiny size: the
control (the reference in the program's place, its convs in float8, one
precision below the configuration's bfloat16), and a run whose timed path
is broken underneath (a step that leaves its state unchanged; half of each
batch left out; a kernel's output, or the gradient it hands back, altered
where it is produced), each fault planted in what the run builds. The
harness's look for a card is skipped; everything else runs as a run does.
"""

import os
import shutil
import tempfile

import pytest
import torch

from benchmark.core.check import gaps, verdict
from benchmark.core.runner import run
from benchmark.reference.follow import follow
from benchmark.tests.conftest import ROOT
from benchmark.traffic_gen.synth import write_dataset

SEED = 2 ** 31 + 23


@pytest.mark.parametrize("workload", ["train.unetpp.b4", "train.unet.b4"])
def test_control_is_not_correct(workload, tiny_cell):
    cell = tiny_cell(workload)
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
    assert values["disc_grad_error"] > cell.limits["disc_grad_error"]


def _unchanged(trainer):
    for opt in (trainer.state.opt_g, trainer.state.opt_d):
        opt.step = lambda *a, **k: None


def _half_batch(trainer):
    compute = trainer.step_fn.compute

    def half(state, src, tgt, **kw):
        n = src.shape[0] // 2
        return compute(state, src[:n], tgt[:n], **kw)
    trainer.step_fn.compute = half


class _NoisyGrad(torch.autograd.Function):
    """Passes the value; adds noise to the gradient it hands back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        noise = torch.randn(g.shape, generator=_NoisyGrad.gen)
        return g + 0.05 * g.std() * noise


def _altered_norm(monkeypatch, backward=False):
    from tactile_gan_torch.models import blocks

    act = blocks.instance_norm_act
    gen = torch.Generator().manual_seed(0)
    _NoisyGrad.gen = gen

    def altered(x, *a, **k):
        if backward:  # the gradient of a norm's input (kernel C's output)
            return act(_NoisyGrad.apply(x), *a, **k)
        # Noise: a scale or a shift of a norm's output is undone by the
        # next instance norm.
        y = act(x, *a, **k)
        return y + 0.05 * torch.randn(y.shape, generator=gen)
    monkeypatch.setattr(blocks, "instance_norm_act", altered)


def _plant(monkeypatch, fault):
    """Breaks every ``Trainer`` built from here on with ``fault``."""
    from tactile_gan_torch.train import loop

    init = loop.Trainer.__init__

    def broken(self, *a, **k):
        init(self, *a, **k)
        fault(self)
    monkeypatch.setattr(loop.Trainer, "__init__", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_norm",
                                   "altered_norm_grad"])
def test_broken_timed_path_is_not_correct(fault, tiny_cell, monkeypatch):
    cell = tiny_cell("train.unetpp.b4")
    if fault.startswith("altered_norm"):
        _altered_norm(monkeypatch, backward=fault.endswith("grad"))
    else:
        _plant(monkeypatch, {"unchanged": _unchanged,
                             "half_batch": _half_batch}[fault])
    result, lines = run(ROOT, cell, SEED, 0.5, False, "cpu", 0.0)
    assert result["correct"] is False, lines
    if fault == "altered_norm_grad":  # G's backward, seen entry by entry
        gen = result["checks"]["gen_grad_error"]
        assert gen["value"] > gen["limit"], lines


def test_sound_run_is_correct(tiny_cell):
    result, lines = run(ROOT, tiny_cell("train.unetpp.b4"), SEED, 0.5, False,
                        "cpu", 0.0)
    assert result["correct"] is True, lines
    assert torch.get_num_threads() <= 4
