"""SPADE's generator (``--gen SPADE``, ``tactile_gan_torch/models/spade.py``)
against the plain NCHW reference ``tests/spade_ref.py``: the forward and
every parameter's gradient on one shared set of seeded weights, the
parameter count at the published widths, the layer counter, the layers'
marks in the forward and the backward, and one training step through the
port's ``TrainConfig``. CPU tests at nf 8, 64 px, batch 2. Imports no JAX,
so the card's test at the end runs on the card's machine too:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_spade.py -q
"""

import math

import pytest
import torch

import spade_ref
from tactile_gan_torch.core.config import TrainConfig, config_from_args
from tactile_gan_torch.models.factory import create_generator
from tactile_gan_torch.models.spade import LAYER, SPADE, SPADEGenerator
from tactile_gan_torch.ops.kernels import marks
from tactile_gan_torch.utils import profiling

NF, SIZE, BATCH = 8, 64, 2
LAYERS = 18  # 2 in each of head_0, G_middle_0, G_middle_1; 3 in each up_*
SPADE_MARKS = set(profiling.layer_marks(LAYER))
FORWARD = ["tg_mark_spade_in", "tg_mark_spade_out"]
BACKWARD = ["tg_mark_spade_bwd_out", "tg_mark_spade_bwd_in"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _shared_weights(model, seed=0):
    """One seeded draw for every parameter, off the published
    initialization so that every bias and modulation counts."""
    g = torch.Generator().manual_seed(seed)
    return {name: 0.05 * torch.randn(p.shape, generator=g)
            for name, p in model.named_parameters()}


def _pair(nf=NF):
    port = create_generator("SPADE", nf=nf)
    ref = spade_ref.SPADEGenerator(nf=nf)
    weights = _shared_weights(ref)
    assert sorted(dict(port.named_parameters())) == sorted(weights)
    port.load_state_dict(weights)
    ref.load_state_dict(weights)
    return port, ref


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((BATCH, SIZE, SIZE, 3), generator=g) * 2 - 1
    probe = torch.randn((BATCH, SIZE, SIZE, 3), generator=g)
    return x, probe


def test_forward_and_gradients_match_the_reference():
    port, ref = _pair()
    x, probe = _inputs()
    got = port(x)
    want = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    # A loss whose gradients are of order one: sum(out * N(0, 1)) / sqrt(n).
    scale = 1.0 / math.sqrt(probe.numel())
    got_g = torch.autograd.grad((got * probe).sum() * scale,
                                list(port.parameters()))
    want_g = torch.autograd.grad((want * probe).sum() * scale,
                                 list(ref.parameters()))
    names = [n for n, _ in port.named_parameters()]
    ref_names = [n for n, _ in ref.named_parameters()]
    want_by = dict(zip(ref_names, want_g))
    for name, g in zip(names, got_g):
        torch.testing.assert_close(g, want_by[name], rtol=1e-4, atol=1e-5,
                                   msg=lambda m, n=name: f"{n}: {m}")


def test_parameter_count_at_the_published_widths():
    with torch.device("meta"):
        gen = SPADEGenerator(nf=64)
    params = dict(gen.named_parameters())
    assert sum(p.numel() for p in params.values()) == 92_059_587
    assert sum(p.numel() for n, p in params.items()
               if ".norm_" in n) == 25_301_376
    assert sum(isinstance(m, SPADE) for m in gen.modules()) == LAYERS


def test_spade_calls_count_the_layers_a_forward():
    """The depth is the class's own at every nf: 18 layers a forward."""
    gen = SPADEGenerator(nf=NF)
    x, _ = _inputs()
    before = SPADE.calls
    with torch.no_grad():
        gen(x)
    assert SPADE.calls - before == LAYERS
    gen(x)
    assert SPADE.calls - before == 2 * LAYERS


def test_marks_bracket_each_layer_forward_and_backward(monkeypatch):
    """in, out for each layer in the forward; its exit's twin, then its
    entry's, for each layer in the backward, none nested in another."""
    seen = []
    monkeypatch.setattr(marks, "mark", lambda symbol, like: seen.append(
        symbol))
    gen = SPADEGenerator(nf=NF)
    x, probe = _inputs()
    y = gen(x)
    assert seen == FORWARD * LAYERS
    seen.clear()
    (y * probe).sum().backward()
    assert seen == BACKWARD * LAYERS


def test_sizes_off_the_trunks_grid_are_refused():
    with pytest.raises(ValueError, match="multiple of 32"):
        SPADEGenerator(nf=NF)(torch.zeros(1, 48, 48, 3))


def test_train_config_builds_and_takes_a_step():
    """``--gen SPADE`` parses, and its TrainConfig builds both networks and
    takes one eager step (the GP on) that moves every weight of G. (Not
    every bias: conv_0's feed a parameter-free norm, so their gradient is
    zero but for rounding.)"""
    assert config_from_args(["--gen", "SPADE"]).gen == "SPADE"
    cfg = TrainConfig(gen="SPADE", nf=NF, image_size=SIZE, batch_size=BATCH,
                      compute_dtype="float32", lambda_per=0.0, device="cpu")
    fs = profiling.fixed_step(cfg, seed=0, device="cpu")
    assert isinstance(fs.state.gen, SPADEGenerator)
    before = {n: p.detach().clone()
              for n, p in fs.state.gen.named_parameters()}
    losses = fs.eager(apply_gp=True)
    assert torch.isfinite(losses).all() and losses[3] > 0
    weights = [n for n in before if n.endswith("weight")]
    assert len(weights) == 74  # 54 in the SPADE layers
    assert all(not torch.equal(p, before[n]) for n, p in
               fs.state.gen.named_parameters() if n in weights)


@pytest.mark.cuda
def test_graph_replay_carries_the_layer_marks():
    """On the card: a profiled replay of the graphed SPADE step launches
    each layer's two forward marks inside ``step.g_fwd`` and its two
    backward marks inside ``step.g_bwd``, in order, and the card's forward
    at float32 compute matches the reference's on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the markers and the graph run there")
    port, ref = _pair()
    x, _ = _inputs()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # float32 convs, not TF32
    try:
        with torch.no_grad():
            got = port.cuda()(x.cuda()).cpu()
            want = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    cfg = TrainConfig(gen="SPADE", nf=NF, image_size=SIZE, batch_size=BATCH)
    fs = profiling.fixed_step(cfg, seed=3, device="cuda")
    fs(apply_gp=True)  # eager on the side stream, then captured
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fs(apply_gp=True)
        torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.name.startswith("tg_mark_"))
    keep = SPADE_MARKS | {"tg_mark_g_fwd", "tg_mark_d_fwd", "tg_mark_g_bwd",
                          "tg_mark_g_adam"}
    assert [n for _, n in kernels if n in keep] == (
        ["tg_mark_g_fwd"] + FORWARD * LAYERS + ["tg_mark_d_fwd"]
        + ["tg_mark_g_bwd"] + BACKWARD * LAYERS + ["tg_mark_g_adam"])
