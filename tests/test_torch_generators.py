"""The port's UNet and BCDUNet generators against the JAX package on the same
numpy inputs and weights: the transposed conv, both forwards, kernels A and
C's plain versions at the generators' norm forms, one training step of each,
and their checkpoints in both directions.

JAX weights come from ``jax.eval_shape`` and numpy draws, never from
``Module.init``, whose trace of UNet at 256x256 costs tens of seconds on the
CPU.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.core.config import TrainConfig as JaxTrainConfig
from tactile_gan_tpu.models import vgg as jax_vgg
from tactile_gan_tpu.models.factory import (
    create_discriminator as jax_create_discriminator,
    create_generator as jax_create_generator,
)
from tactile_gan_tpu.ops.conv import conv2d_transpose as jax_conv2d_transpose
from tactile_gan_tpu.ops.pallas.instance_norm import (
    instance_norm_act as pallas_instance_norm_act,
)
from tactile_gan_tpu.train.schedule import multistep_lr as jax_multistep_lr
from tactile_gan_tpu.train.state import TrainState as JaxTrainState
from tactile_gan_tpu.train.state import make_optimizer as jax_make_optimizer
from tactile_gan_tpu.train.step import build_train_step as jax_build_train_step
from tactile_gan_tpu.utils import checkpoint as jax_checkpoint
from tactile_gan_tpu.utils.torch_migrate import (
    bcdunet_from_torch, detect_generator, unet_from_torch,
)

from test_torch_train import (
    _assert_updates_close, _jax_draws, _jax_vgg_tower, _randomize,
    _write_train_pairs,
)

from tactile_gan_torch.cli import test as test_cli
from tactile_gan_torch.cli import train as train_cli
from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.eval.runner import load_model
from tactile_gan_torch.models import blocks
from tactile_gan_torch.models.bcdunet import BCDUNet
from tactile_gan_torch.models.blocks import init_weights
from tactile_gan_torch.models.factory import create_generator
from tactile_gan_torch.models.patch_discriminator import PatchDiscriminator
from tactile_gan_torch.models.unet import UNet
from tactile_gan_torch.ops.conv import conv2d_transpose
from tactile_gan_torch.ops.kernels import instance_norm as ka
from tactile_gan_torch.train.schedule import multistep_lr
from tactile_gan_torch.train.state import TrainState, make_optimizer
from tactile_gan_torch.train.step import build_train_step
from tactile_gan_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tactile_gan_torch.utils.convert import (
    LEAVES, adam_moments, bcdunet_jax_params_from_state_dict,
    bcdunet_state_dict_from_jax, jax_params_from_state_dict, load_adam_state,
    patchdisc_state_dict_from_jax, state_dict_from_jax,
    unet_jax_params_from_state_dict, unet_state_dict_from_jax,
)

torch.set_num_threads(2)

# The smallest size of each generator's domain in these tests: UNet needs
# 256 px (seven stride-2 stages), BCDUNet any multiple of 8.
SIZES = {"UNet": (256, 2, 1), "BCDUNet": (32, 4, 2)}  # size, nf, batch
PORT = {"UNet": UNet, "BCDUNet": BCDUNet}
# Norms a forward runs: UNet 7 DownBlocks and 7 UpBlocks, BCDUNet 7 double
# convs, two each.
NORMS = {"UNet": 28, "BCDUNet": 14}
LR, BETA1 = 1e-3, 0.9
# One bf16 rounding of the output on each side: a flipped rounding is one
# bf16 ulp (<= 2^-7 of the value); 2^-6 covers the neighbouring binade.
BF16_TOL = dict(atol=1e-2, rtol=2.0 ** -6)


def _jax_params(name, seed):
    """A JAX generator param tree ({'params': ...}) of numpy leaves: conv
    kernels and biases N(0, 0.1), norm scales 1 + N(0, 0.1)."""
    size, nf, _ = SIZES[name]
    model = jax_create_generator(name, 3, nf, activation=True)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3)))
    return _randomize(shapes, seed)


def _input(name, seed):
    size, _, batch = SIZES[name]
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32)


def _port(name, params, compute_dtype=torch.float32):
    _, nf, _ = SIZES[name]
    m = PORT[name](nf=nf, compute_dtype=compute_dtype)
    m.load_state_dict(state_dict_from_jax(params, name), strict=True)
    return m.eval()


def _forward(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def _jax_forward(name, params, x, dtype="float32"):
    _, nf, _ = SIZES[name]
    model = jax_create_generator(name, 3, nf, activation=True,
                                 compute_dtype=jnp.dtype(dtype))
    return np.asarray(jax.jit(model.apply)(params, jnp.asarray(x)))


@pytest.fixture(scope="module", params=["UNet", "BCDUNet"])
def forward_case(request):
    """(name, params, input, the JAX float32 forward) of each generator."""
    name = request.param
    params = _jax_params(name, 1)
    x = _input(name, 2)
    return name, params, x, _jax_forward(name, params, x)


# ---------------------------------------------------------------------------
# The transposed conv.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,pad", [(4, 2, 1), (2, 2, 0)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_conv2d_transpose_matches_jax(k, stride, pad, bias, compute):
    rng = np.random.default_rng(k + 10 * bias)
    x = rng.normal(size=(2, 5, 7, 12)).astype(np.float32)
    w = (0.1 * rng.normal(size=(12, 8, k, k))).astype(np.float32)  # IOHW
    b = (0.1 * rng.normal(size=(8,))).astype(np.float32) if bias else None
    want = np.asarray(jax_conv2d_transpose(
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 0, 1)), stride=stride,
        padding=pad, bias=None if b is None else jnp.asarray(b),
        compute_dtype=jnp.dtype(compute)))
    got = conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                           stride=stride, padding=pad,
                           bias=None if b is None else torch.from_numpy(b),
                           compute_dtype=getattr(torch, compute))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, (5 - 1) * stride - 2 * pad + k,
                                       (7 - 1) * stride - 2 * pad + k, 8)
    # float32: sums of up to 12 * 4 products in another order. bfloat16:
    # both round the same bf16 operands' product to bf16 once.
    tol = BF16_TOL if compute == "bfloat16" else dict(atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, **tol)


# ---------------------------------------------------------------------------
# The generators' forwards, names and routing.
# ---------------------------------------------------------------------------

def test_generator_forward_matches_jax(forward_case):
    name, params, x, want = forward_case
    got = _forward(_port(name, params), x)
    assert got.shape == want.shape == x.shape
    # float32 sums in another order, through instance norms down to UNet's
    # 2x2 maps and BCDUNet's 4x4 ones.
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_generator_bf16_forward_matches_jax(forward_case):
    """bf16 conv operands on both sides; each side rounds each conv's output
    to bf16 once and sums in its own order, so both lie within about 0.05
    of the float32 network. The port must agree with JAX to twice that, and
    sit no further from the float32 network than twice JAX's own error."""
    name, params, x, truth = forward_case
    want = _jax_forward(name, params, x, "bfloat16")
    got = _forward(_port(name, params, torch.bfloat16), x)
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
    assert np.abs(got - want).mean() < 1e-2
    assert np.abs(got - truth).mean() <= 2 * np.abs(want - truth).mean()


@pytest.mark.parametrize("name", ["UNet", "BCDUNet"])
def test_state_dict_names_are_the_references(name):
    """The port's state_dict goes through the JAX package's reader of
    reference checkpoints (torch_migrate) to the JAX tree it came from, and
    back through utils/convert.py unchanged."""
    migrate, to_port, from_port = {
        "UNet": (unet_from_torch, unet_state_dict_from_jax,
                 unet_jax_params_from_state_dict),
        "BCDUNet": (bcdunet_from_torch, bcdunet_state_dict_from_jax,
                    bcdunet_jax_params_from_state_dict)}[name]
    params = _jax_params(name, 3)
    _, nf, _ = SIZES[name]
    port = PORT[name](nf=nf)
    port.load_state_dict(to_port(params), strict=True)
    sd = port.state_dict()
    assert set(sd) == {n for _, n, _ in LEAVES[name]}
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    assert detect_generator(numpy_sd)[0] == name
    theirs = jax.tree_util.tree_leaves_with_path(params["params"])
    for tree in (migrate(numpy_sd), from_port(sd)):
        ours = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in ours] == [p for p, _ in theirs]
        for (_, a), (_, b) in zip(ours, theirs):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["UNet", "BCDUNet"])
def test_factory_builds_the_generator(name):
    size, nf, _ = SIZES[name]
    gen = create_generator(name.lower(), nf=nf)
    assert type(gen) is PORT[name]
    assert set(gen.state_dict()) == {n for _, n, _ in LEAVES[name]}


@pytest.mark.parametrize("name", ["UNet", "BCDUNet"])
def test_every_norm_goes_through_the_kernel_wrapper(name, monkeypatch):
    """Each of the generator's norms calls instance_norm_act (kernel A on
    the card): affine for UNet, with no scale or offset for BCDUNet."""
    calls = []
    real = blocks.instance_norm_act

    def spy(x, weight=None, bias=None, **kw):
        calls.append((weight is None, bias is None))
        return real(x, weight, bias, **kw)

    monkeypatch.setattr(blocks, "instance_norm_act", spy)
    size, nf, _ = SIZES[name]
    gen = create_generator(name, nf=nf)
    with torch.no_grad():
        gen(torch.zeros(1, size, size, 3))
    non_affine = name == "BCDUNet"
    assert calls == [(non_affine, non_affine)] * NORMS[name]


def test_unet_refuses_inputs_below_256():
    with pytest.raises(ValueError, match="at least 256x256"):
        UNet(nf=2)(torch.zeros(1, 128, 128, 3))


def test_init_weights_draws_transposed_convs():
    """Transposed convs get N(0, 0.02) and zero biases like every conv, not
    PyTorch's default init."""
    gen = BCDUNet(nf=8)
    init_weights(gen, torch.Generator().manual_seed(0))
    for i in (1, 2, 3):
        up = getattr(gen, f"upconv{i}")
        assert abs(up.weight.std().item() - 0.02) < 0.004
        assert torch.equal(up.bias, torch.zeros_like(up.bias))
    unet = UNet(nf=2)
    init_weights(unet, torch.Generator().manual_seed(0))
    w = torch.cat([getattr(unet, f"deconv{i}").layer[0].weight.flatten()
                   for i in range(2, 9)])
    assert abs(w.std().item() - 0.02) < 0.002


def test_reference_bcdunet_checkpoint_with_clstm_loads_non_strict(tmp_path):
    """A reference BCDUNet .pth also holds the ConvLSTM weights its forward
    never calls; the serving loader skips them (strict=False, as the
    reference) and serves the live network's weights."""
    name = "BCDUNet"
    params = _jax_params(name, 4)
    sd = state_dict_from_jax(params, name)
    sd["clstm1.cell_list.0.conv.weight"] = torch.zeros(4, 8, 3, 3)
    path = os.path.join(str(tmp_path), "final_model.pth")
    save_checkpoint(path, gen=sd)
    _, nf, _ = SIZES[name]
    cfg = TrainConfig(gen=name, nf=nf, compute_dtype="float32")
    forward, gen = load_model(path, cfg, device="cpu")
    for k, v in gen.state_dict().items():
        assert torch.equal(v, sd[k])


# ---------------------------------------------------------------------------
# Kernels A and C's plain versions at the generators' norm forms.
# ---------------------------------------------------------------------------

# UNet's deepest norm form (2x2 maps, affine) and BCDUNet's (non-affine).
NORM_FORMS = [((2, 2, 2, 64), True), ((2, 4, 4, 32), False)]


@pytest.mark.parametrize("shape,affine", NORM_FORMS)
def test_instance_norm_plain_matches_pallas_at_generator_forms(shape, affine):
    """Forward and backward of the port's Function (the plain versions on
    the CPU) against the Pallas kernel in interpret mode and its VJP."""
    rng = np.random.default_rng(29)
    c = shape[-1]
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    s = (1 + 0.5 * rng.normal(size=(c,))).astype(np.float32) if affine else None
    o = (0.5 * rng.normal(size=(c,))).astype(np.float32) if affine else None
    jargs = [jnp.asarray(x)] + ([jnp.asarray(s), jnp.asarray(o)]
                                if affine else [])
    want, vjp = jax.vjp(lambda *a: pallas_instance_norm_act(
        *a, act="relu", interpret=True), *jargs)
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_()]
    if affine:
        leaves += [torch.from_numpy(s).requires_grad_(),
                   torch.from_numpy(o).requires_grad_()]
    y = ka.instance_norm_act(*leaves, act="relu")
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    # Four or sixteen pixels a plane: the Pallas kernel's single-pass
    # E[x^2]-m^2 against the plain two-pass variance, |mean|/std ~ 1/3.
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=5e-5, rtol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_grads[0]),
                               atol=2e-5, rtol=1e-4)
    for a, b in zip(grads[1:], want_grads[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# One training step of each generator against the JAX step.
# ---------------------------------------------------------------------------

def _zero_grad_biases(name):
    """The biases whose true gradient is exactly zero: BCDUNet's conv biases
    that feed a non-affine instance norm, which removes each channel's
    mean. What either package computes for them is rounding noise, which
    Adam turns into updates of about lr with an arbitrary sign."""
    if name != "BCDUNet":
        return set()
    blocks_ = [f"conv{i}" for i in range(1, 5)] + [f"conv{i}m"
                                                   for i in range(1, 4)]
    return {f"{b}.{u}.bias" for b in blocks_ for u in (0, 3)}


@pytest.fixture(scope="module", params=["UNet", "BCDUNet"])
def jax_step(request):
    """One JAX step at float32 compute, GP, v1 perceptual loss (the JAX
    fallback tower) and label smoothing on: the state before and after,
    the losses and the draws."""
    name = request.param
    size, nf, batch = SIZES[name]
    cfg = JaxTrainConfig(gen=name, nf=nf, batch_size=batch, image_size=size,
                         compute_dtype="float32", lr=LR, beta1=BETA1)
    gen = jax_create_generator(name, 3, nf, activation=True)
    disc = jax_create_discriminator("patch", nf, activation=True)
    sched = jax_multistep_lr(LR, cfg.epoch_constant, cfg.total_epochs, 100)
    g_tx, d_tx = jax_make_optimizer(sched, BETA1), jax_make_optimizer(
        sched, BETA1)
    ex = jnp.zeros((1, size, size, 3))
    g_params = _jax_params(name, 5)
    d_params = _randomize(jax.eval_shape(disc.init, jax.random.key(0), ex,
                                         ex), 6)
    state = JaxTrainState(g_params=g_params, d_params=d_params,
                          g_opt_state=g_tx.init(g_params),
                          d_opt_state=d_tx.init(d_params),
                          step=jnp.zeros((), jnp.int32))
    jt, pt = _jax_vgg_tower()
    step = jax_build_train_step(cfg, gen, disc, g_tx, d_tx,
                                vgg_apply=jax_vgg.vgg_features_apply,
                                vgg_params=jt)
    rng = np.random.default_rng(43)
    src = rng.integers(0, 255, (batch, size, size, 3), np.uint8)
    tgt = rng.integers(0, 255, (batch, size, size, 3), np.uint8)
    key = jax.random.key(7)
    before = jax.device_get(state)
    after, m = step(state, jnp.asarray(src), jnp.asarray(tgt), key,
                    apply_gp=True)
    d_size = (((size - 3) // 2 + 1 - 3) // 2 + 1) - 6  # 3 valid 3x3 convs
    return dict(name=name, before=before, after=jax.device_get(after),
                losses=[float(v) for v in (m.loss_d, m.loss_g, m.loss_l1,
                                           m.loss_gp, m.loss_per)],
                draws=_jax_draws(key, 0, (batch, d_size, d_size, 1)),
                vgg=pt, src=src, tgt=tgt, cfg=cfg)


def _port_step(r):
    name = r["name"]
    size, nf, batch = SIZES[name]
    gen = PORT[name](nf=nf, compute_dtype=torch.float32)
    gen.load_state_dict(state_dict_from_jax(r["before"].g_params, name))
    disc = PatchDiscriminator(nf=nf)
    disc.load_state_dict(patchdisc_state_dict_from_jax(r["before"].d_params))
    state = TrainState(gen, disc, make_optimizer(gen.parameters(), LR, BETA1),
                       make_optimizer(disc.parameters(), LR, BETA1))
    cfg = TrainConfig(gen=name, nf=nf, batch_size=batch, image_size=size,
                      compute_dtype="float32", lr=LR, beta1=BETA1,
                      device="cpu")
    step = build_train_step(cfg, multistep_lr(LR, 25, 135, 100), r["vgg"])
    noise, alpha = r["draws"]
    losses = step(state, torch.from_numpy(r["src"]),
                  torch.from_numpy(r["tgt"]), apply_gp=True,
                  label_noise=noise, gp_alpha=alpha)
    return state, losses.numpy()


@pytest.fixture(scope="module")
def port_step(jax_step):
    return _port_step(jax_step)


def test_train_step_matches_jax(jax_step, port_step):
    """Losses within rel 1e-4, every update within the step-parity
    statistics of tests/test_torch_train.py; BCDUNet's zero-gradient biases
    are held to the noise floor instead (the next test)."""
    name = jax_step["name"]
    state, got = port_step
    want = np.asarray(jax_step["losses"])
    assert np.all(want[3:] > 0)  # GP and perceptual terms really ran
    np.testing.assert_allclose(got, want, rtol=1e-4)
    skip = {path for path, n, _ in LEAVES[name]
            if n in _zero_grad_biases(name)}
    ours = jax_params_from_state_dict(state.gen.state_dict(), name)
    theirs = jax_step["after"].g_params["params"]
    lo = jax.tree_util.tree_leaves_with_path(ours)
    lt = jax.tree_util.tree_leaves_with_path(theirs)
    assert [p for p, _ in lo] == [p for p, _ in lt]
    kept_o, kept_t = [], []
    for (path, a), (_, b) in zip(lo, lt):
        if tuple(k.key for k in path) in skip:
            continue
        if np.asarray(a).size >= 256:
            _assert_updates_close(a, b, f"G {path}")
        kept_o.append(np.ravel(a))
        kept_t.append(np.ravel(b))
    _assert_updates_close(np.concatenate(kept_o), np.concatenate(kept_t),
                          "G pooled")
    ours_d = jax_params_from_state_dict(state.disc.state_dict(), "patch")
    _assert_updates_close(
        np.concatenate([np.ravel(a) for a in jax.tree.leaves(ours_d)]),
        np.concatenate([np.ravel(a) for a in jax.tree.leaves(
            jax_step["after"].d_params["params"])]), "D pooled")
    assert len(skip) == len(_zero_grad_biases(name))


def test_zero_gradient_biases_are_at_the_noise_floor(jax_step, port_step):
    """Each side's first-step gradient (Adam's first moment / (1 - beta1))
    of a bias that feeds a non-affine norm lies below 1e-6 of the largest
    gradient of its conv's weight, in both packages."""
    name = jax_step["name"]
    biases = _zero_grad_biases(name)
    state, _ = port_step
    if not biases:  # UNet: every conv is bias-free but the head's
        assert [n for _, n, _ in LEAVES[name] if n.endswith(".bias")
                and ".layer.1." not in n and ".layer.4." not in n] == [
            "downfeature.conv.bias"]
        return
    mu, _, count = adam_moments(state.opt_g, state.gen,
                                lambda sd: {k: v.numpy()
                                            for k, v in sd.items()})
    adam = jax_step["after"].g_opt_state[0]
    assert count == int(adam.count) == 1
    theirs = {k: v.numpy() for k, v in
              state_dict_from_jax(adam.mu, name).items()}
    for grads in (mu, theirs):
        for b in sorted(biases):
            w = b.replace(".bias", ".weight")
            ratio = np.abs(grads[b]).max() / np.abs(grads[w]).max()
            assert ratio < 1e-6, (b, ratio)


# ---------------------------------------------------------------------------
# Checkpoints in both directions.
# ---------------------------------------------------------------------------

def _adam_like(tx, params, seed):
    """optax.adam's state for ``params`` after three updates, with drawn
    moments: mu N(0, 1e-3), nu = (10 mu)^2 + 1e-8, so that an update from
    it moves each weight by less than the learning rate."""
    st = tx.init(params)
    mu = _randomize(params, seed, 1e-3)
    nu = jax.tree.map(lambda m: (10 * m) ** 2 + 1e-8, mu)
    return (st[0]._replace(count=jnp.asarray(3, jnp.int32), mu=mu, nu=nu),
            ) + tuple(st[1:])


@pytest.mark.parametrize("name", ["UNet", "BCDUNet"])
def test_jax_msgpack_checkpoint_converts_with_its_adam_state(name, tmp_path):
    """A JAX msgpack final_model.pth of the generator reads into the port:
    every weight and both Adam moments exactly, and the Adam state loads
    into the port's optimizer and comes back unchanged."""
    size, nf, _ = SIZES[name]
    params = _jax_params(name, 8)
    disc = jax_create_discriminator("patch", nf, activation=True)
    ex = jnp.zeros((1, size, size, 3))
    d_params = _randomize(jax.eval_shape(disc.init, jax.random.key(0), ex,
                                         ex), 9)
    tx = jax_make_optimizer(lambda _: LR, BETA1)
    opt_g = _adam_like(tx, params, 10)
    path = os.path.join(str(tmp_path), "final_model.pth")
    jax_checkpoint.save_checkpoint(path, gen=params, disc=d_params,
                                   opt_g=opt_g,
                                   opt_d=_adam_like(tx, d_params, 12),
                                   step=3)
    ckpt = load_checkpoint(path)
    assert ckpt["step"] == 3
    gen = PORT[name](nf=nf)
    gen.load_state_dict(ckpt["gen"], strict=True)
    back = jax_params_from_state_dict(gen.state_dict(), name)
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(params["params"])):
        assert np.array_equal(a, b)
    saved = ckpt["optimizerG_state_dict"]
    opt = make_optimizer(gen.parameters(), LR, BETA1)
    load_adam_state(opt, gen, saved["mu"], saved["nu"], saved["count"], dict)
    mu, nu, count = adam_moments(opt, gen, lambda sd: (
        jax_params_from_state_dict(sd, name)))
    assert count == 3
    for ours, theirs in ((mu, opt_g[0].mu["params"]),
                         (nu, opt_g[0].nu["params"])):
        for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ours),
                                  jax.tree_util.tree_leaves_with_path(theirs)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["UNet", "BCDUNet"])
def test_port_checkpoint_reads_into_jax(name, tmp_path):
    params = _jax_params(name, 14)
    gen = _port(name, params)
    path = os.path.join(str(tmp_path), "final_model.pth")
    save_checkpoint(path, gen=gen.state_dict(), step=5)
    theirs = jax_checkpoint.load_checkpoint(path)["gen"]["params"]
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(theirs),
            jax.tree_util.tree_leaves_with_path(params["params"])):
        assert pa == pb and np.array_equal(np.asarray(a), b)


def test_jax_checkpoint_is_served_by_load_model(forward_case, tmp_path):
    """load_model reads a JAX-written msgpack final_model.pth of the
    generator and its forward equals the JAX forward."""
    name, params, x, want = forward_case
    size, nf, _ = SIZES[name]
    path = os.path.join(str(tmp_path), "final_model.pth")
    jax_checkpoint.save_checkpoint(path, gen=params, disc={}, opt_g={},
                                   opt_d={}, step=0)
    cfg = TrainConfig(gen=name, nf=nf, image_size=size,
                      compute_dtype="float32")
    forward, _ = load_model(path, cfg, device="cpu")
    got = forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


# ---------------------------------------------------------------------------
# The CLIs with --gen BCDUNet on the CPU, from and to JAX checkpoints.
# ---------------------------------------------------------------------------

def test_cli_trains_serves_and_resumes_bcdunet_from_jax(tmp_path):
    """cli.train --gen BCDUNet for one step and cli.test on its folder; then
    a JAX-written msgpack checkpoint is served by cli.test and resumed by
    --continue_training, which starts from its weights, Adam state and
    step."""
    name, size, nf = "BCDUNet", 32, 4
    root = str(tmp_path)
    data = os.path.join(root, "data")
    _write_train_pairs(data, n=2, size=size, seed=5)
    src = os.path.join(data, "train")
    os.symlink(src, os.path.join(data, "test"))
    common = ["--data", data, "--gen", name, "--nf", str(nf),
              "--image_size", str(size), "--batch_size", "2",
              "--total_epochs", "1", "--epoch_constant", "1",
              "--compute_dtype", "float32", "--threads", "2",
              "--device", "cpu"]
    trainer = train_cli.main(common + ["--folder_save", "port"])
    assert type(trainer.gen) is BCDUNet and trainer.state.step == 1
    served = test_cli.main(["--folder", "port", "--work_root", root,
                            "--device", "cpu"])
    assert all(np.isfinite(v) for v in served.values())

    # A JAX-trained folder: its params.txt and msgpack checkpoint.
    params = _jax_params(name, 16)
    tx = jax_make_optimizer(lambda _: LR, BETA1)
    ex = jnp.zeros((1, size, size, 3))
    disc = jax_create_discriminator("patch", nf, activation=True)
    d_params = _randomize(jax.eval_shape(disc.init, jax.random.key(0), ex,
                                         ex), 17)
    jax_dir = os.path.join(root, "models", "jax")
    os.makedirs(jax_dir)
    jax_checkpoint.save_checkpoint(
        os.path.join(jax_dir, "final_model.pth"), gen=params, disc=d_params,
        opt_g=_adam_like(tx, params, 18), opt_d=_adam_like(tx, d_params, 20),
        step=3)
    JaxTrainConfig(data=data, gen=name, nf=nf, image_size=size,
                   compute_dtype="float32", folder_save="jax",
                   folder_load="jax").save_params(jax_dir)
    for k in ("gen", "disc", "l1", "gp", "per"):
        np.save(os.path.join(jax_dir, f"{k}loss.npy"), np.ones(1, np.float32))
    served = test_cli.main(["--folder", "jax", "--work_root", root,
                            "--device", "cpu"])
    assert all(np.isfinite(v) for v in served.values())

    resumed = train_cli.main(common + ["--folder_save", "resumed",
                                       "--continue_training",
                                       "--folder_load", "jax"])
    assert resumed.step_offset == 3 and resumed.state.step == 4
    # The resumed run started from the JAX weights and Adam state: its one
    # step moved each weight by less than twice the learning rate.
    start = state_dict_from_jax(params, name)
    bound = 2 * resumed.cfg.lr
    for k, v in resumed.gen.state_dict().items():
        assert (v - start[k]).abs().max().item() < bound, k
