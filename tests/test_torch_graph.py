"""The bookkeeping around the CUDA-graph step that runs without a card: the
launch-count carry, the in-place learning rate, optimizer state loading
that keeps the device rate and ``capturable``, and the relayout cache under
capture (the capture flag stubbed)."""

import pytest
import torch

from tactile_gan_torch.ops.kernels import conv3x3 as kb
from tactile_gan_torch.train import graph
from tactile_gan_torch.train.state import (
    load_optimizer_state, make_optimizer, set_lr,
)
from tactile_gan_torch.utils.convert import load_adam_state

torch.set_num_threads(2)


@pytest.fixture
def counters(monkeypatch):
    """Every launch counter set to its own start value, restored after."""
    for i, (module, name) in enumerate(graph.LAUNCH_COUNTERS):
        monkeypatch.setattr(getattr(module, name), "launches", 100 + i)
    return graph.read_launches()


def test_launch_carry_moves_the_capture_counts_into_replays(counters):
    per_call = (30, 30, 9, 9, 9, 0, 0)
    with graph.LaunchCarry() as carry:  # the capture's Python calls
        graph.add_launches(per_call)
    assert graph.read_launches() == counters  # a capture launches nothing
    assert carry.counts == per_call
    for _ in range(3):
        carry.replayed()
    assert graph.read_launches() == tuple(
        c + 3 * n for c, n in zip(counters, per_call))


def test_launch_carry_reads_a_wrapper_replaced_on_its_module(counters,
                                                             monkeypatch):
    def faulty(*a):
        return None

    faulty.launches = 0
    monkeypatch.setattr(kb, "dgrad_kernel", faulty)
    with graph.LaunchCarry() as carry:
        kb.dgrad_kernel.launches += 9
    carry.replayed()
    assert faulty.launches == 9 and carry.counts[3] == 9


def test_set_lr_fills_a_tensor_rate_in_place():
    p = torch.nn.Parameter(torch.ones(3))
    rate = torch.tensor(1e-3)
    opt = torch.optim.Adam([p], lr=rate, foreach=False)
    set_lr(opt, 2.5e-4)
    assert opt.param_groups[0]["lr"] is rate
    assert rate.item() == pytest.approx(2.5e-4)
    plain = make_optimizer([torch.nn.Parameter(torch.ones(2))], 1e-3, 0.5)
    assert not plain.param_groups[0]["capturable"]
    set_lr(plain, 4e-4)
    assert plain.param_groups[0]["lr"] == 4e-4


def test_optimizer_state_loads_keeping_the_rate_and_capturable():
    torch.manual_seed(0)
    src_p = torch.nn.Parameter(torch.randn(4, 3))
    src = make_optimizer([src_p], 1e-3, 0.5)
    src_p.grad = torch.randn(4, 3)
    src.step()
    dst_p = torch.nn.Parameter(torch.randn(4, 3))
    rate = torch.tensor(7e-4)
    dst = torch.optim.Adam([dst_p], lr=rate, betas=(0.5, 0.99),
                           capturable=True)
    load_optimizer_state(dst, src.state_dict())
    group = dst.param_groups[0]
    assert group["lr"] is rate and group["capturable"]
    st = dst.state[dst_p]
    assert st["step"].dtype == torch.float32 and float(st["step"]) == 1
    assert torch.equal(st["exp_avg"], src.state[src_p]["exp_avg"])


def test_adam_state_from_jax_moments_keeps_float32_steps():
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=torch.tensor(1e-3),
                           capturable=True)
    sd = {n: torch.full_like(p, 0.5) for n, p in model.named_parameters()}
    load_adam_state(opt, model, sd, sd, 4, dict)
    for p in model.parameters():
        step = opt.state[p]["step"]
        assert step.dtype == torch.float32 and step.device == p.device
        assert float(step) == 4


def test_relayout_cache_never_hits_or_fills_under_capture(monkeypatch):
    w = torch.randn(16, 24, 3, 3)
    kb.invalidate_relayouts()
    monkeypatch.setattr(kb, "_capturing", lambda weight: True)
    first = kb._kernel_weight(w, torch.bfloat16, "forward_sm90")
    again = kb._kernel_weight(w, torch.bfloat16, "forward_sm90")
    assert again is not first and torch.equal(again, first)
    assert w not in kb._relaid
    monkeypatch.setattr(kb, "_capturing", lambda weight: False)
    cached = kb._kernel_weight(w, torch.bfloat16, "forward_sm90")
    assert kb._kernel_weight(w, torch.bfloat16, "forward_sm90") is cached
    monkeypatch.setattr(kb, "_capturing", lambda weight: True)
    assert kb._kernel_weight(w, torch.bfloat16, "forward_sm90") is not cached
    monkeypatch.setattr(kb, "_capturing", lambda weight: False)
    kb.invalidate_relayouts()  # what a replay does after it
    assert kb._kernel_weight(w, torch.bfloat16, "forward_sm90") is not cached


def test_cpu_tensors_are_never_seen_as_captured():
    assert not kb._capturing(torch.ones(1))


def test_graphed_step_needs_a_cuda_generator():
    with pytest.raises(ValueError, match="CUDA generator"):
        graph.GraphedStep(None, None, torch.Generator())
