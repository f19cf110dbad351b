"""The trainer's variants against the JAX step on the same numpy weights,
batches and injected draws (label noise, GP alpha, augmentation): version 2
with ``pan_loss``, every ``--loss``, ``--no_label_smoothing``,
``--legacy_label_cache`` over two steps, ``--disc_same_pad``,
``--no-host_aug`` and ``--space_to_depth``; ``pan_loss`` itself; the
version-2 pan term's zero gradient on G; and the loss's activations reaching
both networks.

Tolerances are those of ``tests/test_torch_train.py``'s ``_check_step``:
the five losses within rel 1e-4, every update by ``_assert_updates_close``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.core.config import TrainConfig as JaxTrainConfig
from tactile_gan_tpu.data.augment import (
    _inverse_affine_matrix as jax_inverse_affine_matrix,
)
from tactile_gan_tpu.losses.perceptual import pan_loss as jax_pan_loss
from tactile_gan_tpu.models.factory import (
    create_discriminator as jax_create_discriminator,
    create_generator as jax_create_generator,
)
from tactile_gan_tpu.train.schedule import multistep_lr as jax_multistep_lr
from tactile_gan_tpu.train.state import TrainState as JaxTrainState
from tactile_gan_tpu.train.state import make_optimizer as jax_make_optimizer
from tactile_gan_tpu.train.step import build_train_step as jax_build_train_step

from test_torch_train import _assert_updates_close, _host, _randomize

from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.data.augment import AugmentDraws
from tactile_gan_torch.losses.perceptual import pan_loss
from tactile_gan_torch.models.factory import networks
from tactile_gan_torch.train.schedule import multistep_lr
from tactile_gan_torch.train.state import TrainState, make_optimizer
from tactile_gan_torch.train.step import build_train_step
from tactile_gan_torch.utils.convert import (
    jax_params_from_state_dict, load_adam_state, state_dict_from_jax,
)

torch.set_num_threads(2)

NF, SIZE, BATCH = 4, 64, 2
LR, BETA1 = 1e-3, 0.9


# ---------------------------------------------------------------------------
# pan_loss.
# ---------------------------------------------------------------------------

def _features(seed):
    """Four NHWC feature maps of the discriminator's shapes at nf 4."""
    rng = np.random.default_rng(seed)
    shapes = ((2, 31, 31, 4), (2, 15, 15, 8), (2, 13, 13, 16),
              (2, 11, 11, 32))
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("mode", ["normal", "gram"])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_pan_loss_matches_jax(mode, loss_type):
    real, fake = _features(1), _features(2)
    w = (0.0, 0.1, 0.3, 0.6) if mode == "normal" else (1.0, 2.0, 3.0, 4.0)
    want = jax_pan_loss([jnp.asarray(a) for a in real],
                        [jnp.asarray(a) for a in fake], mode=mode,
                        loss_type=loss_type, weights=w)
    got = pan_loss([torch.from_numpy(a) for a in real],
                   [torch.from_numpy(a) for a in fake], mode=mode,
                   loss_type=loss_type, weights=w)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_pan_loss_refuses_what_jax_refuses():
    f = [torch.from_numpy(a) for a in _features(3)]
    for kw in (dict(mode="style"), dict(loss_type="l3"),
               dict(weights=(1.0, 1.0, 1.0))):
        with pytest.raises(ValueError):
            pan_loss(f, f, **kw)
        with pytest.raises(ValueError):
            jax_pan_loss([jnp.asarray(a.numpy()) for a in f],
                         [jnp.asarray(a.numpy()) for a in f], **kw)


# ---------------------------------------------------------------------------
# One (or two) training steps of each variant against the JAX step.
# ---------------------------------------------------------------------------

# name -> (TrainConfig fields shared by both packages, steps)
VARIANTS = {
    "version2_pan": (dict(version=2, lambda_per=1.0), 1),
    "loss_ce": (dict(loss="ce"), 1),
    "loss_w": (dict(loss="w"), 1),
    "loss_hinge": (dict(loss="hinge"), 1),
    "no_label_smoothing": (dict(no_label_smoothing=True), 1),
    "legacy_label_cache": (dict(legacy_label_cache=True), 2),
    "disc_same_pad": (dict(disc_same_pad=True), 1),
    "no_host_aug": (dict(host_aug=False), 1),
    "space_to_depth": (dict(space_to_depth=True), 1),
}
BASE = dict(gen="UNet++", nf=NF, batch_size=BATCH, image_size=SIZE,
            compute_dtype="float32", lr=LR, beta1=BETA1, lambda_per=0.0)


def jax_aug_draws(k_step, batch, h, w, k_aug=None):
    """The JAX step's augmentation draws (data/augment.py's keys from
    ``k_aug``, by default the step key's augmentation stream), as the port's
    ``AugmentDraws``."""
    if k_aug is None:
        k_aug = jax.random.fold_in(k_step, 2)
    keys = jax.random.split(k_aug, batch)
    flips, affs, mats = [], [], []
    for k in keys:
        k_pf, k_pa, k_aff = jax.random.split(k, 3)
        flips.append(bool(jax.random.uniform(k_pf) < 0.5))
        affs.append(bool(jax.random.uniform(k_pa) < 0.5))
        mats.append(np.asarray(jax_inverse_affine_matrix(k_aff, h, w)))
    return AugmentDraws(torch.tensor(flips), torch.tensor(affs),
                        torch.from_numpy(np.stack(mats)))


def _jax_variant_steps(fields, steps):
    """``steps`` JAX steps of a variant from numpy weights: the states
    before and after each step, the losses and the draws of each step."""
    cfg = JaxTrainConfig(**{**BASE, **fields})
    gen = jax_create_generator("UNet++", 3, NF, activation=cfg.activation,
                               space_to_depth=cfg.space_to_depth)
    disc = jax_create_discriminator("patch", NF, activation=cfg.activation,
                                    same_pad=cfg.disc_same_pad)
    sched = jax_multistep_lr(LR, cfg.epoch_constant, cfg.total_epochs, 100)
    g_tx, d_tx = (jax_make_optimizer(sched, BETA1) for _ in range(2))
    ex = jnp.zeros((BATCH, SIZE, SIZE, 3))
    g_params = _randomize(jax.eval_shape(gen.init, jax.random.key(0), ex), 5)
    d_params = _randomize(jax.eval_shape(disc.init, jax.random.key(1), ex,
                                         ex), 6)
    pred_shape = jax.eval_shape(disc.apply, d_params, ex, ex)[0].shape
    state = JaxTrainState(g_params=g_params, d_params=d_params,
                          g_opt_state=g_tx.init(g_params),
                          d_opt_state=d_tx.init(d_params),
                          step=jnp.zeros((), jnp.int32))
    step = jax_build_train_step(cfg, gen, disc, g_tx, d_tx)
    rng = np.random.default_rng(47)
    src = rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), np.uint8)
    tgt = rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), np.uint8)
    key = jax.random.key(9)
    states, losses, draws = [_host(state)], [], []
    for s in range(steps):
        state, m = step(state, jnp.asarray(src), jnp.asarray(tgt), key,
                        apply_gp=True)
        states.append(_host(state))
        losses.append([float(v) for v in (m.loss_d, m.loss_g, m.loss_l1,
                                          m.loss_gp, m.loss_per)])
        k_step = jax.random.fold_in(key, s)
        k_label = jax.random.fold_in(
            key if cfg.legacy_label_cache else k_step, 3)
        draws.append(dict(
            label_noise=torch.from_numpy(np.array(jax.random.normal(
                k_label, pred_shape, jnp.float32))),
            gp_alpha=torch.from_numpy(np.array(jax.random.uniform(
                jax.random.fold_in(k_step, 4), (BATCH, 1, 1, 1),
                jnp.float32))),
            aug_draws=jax_aug_draws(k_step, BATCH, SIZE, SIZE)))
    return dict(states=states, losses=losses, draws=draws, src=src, tgt=tgt,
                pred_shape=pred_shape)


def _port_cfg(fields, **kw):
    return TrainConfig(**{**BASE, **fields, **kw}, device="cpu")


def _port_state(cfg, jstate):
    """The port's networks of ``cfg`` and their Adam pair from a host copy
    of a JAX TrainState, moments and count included."""
    gen, disc = networks(cfg)
    gen.load_state_dict(state_dict_from_jax(jstate.g_params, "UNet++"))
    disc.load_state_dict(state_dict_from_jax(jstate.d_params, "patch"))
    opt_g = make_optimizer(gen.parameters(), LR, BETA1)
    opt_d = make_optimizer(disc.parameters(), LR, BETA1)
    step = int(jstate.step)
    if step:
        for opt, model, ost, net in ((opt_g, gen, jstate.g_opt_state,
                                      "UNet++"),
                                     (opt_d, disc, jstate.d_opt_state,
                                      "patch")):
            adam = ost[0]
            load_adam_state(opt, model, adam.mu, adam.nu, int(adam.count),
                            lambda t, net=net: state_dict_from_jax(t, net))
    return TrainState(gen, disc, opt_g, opt_d, step=step)


# Under 'w' the D loss is (mean(fake) - mean(real)) / 2 and the GP does not
# see D's head bias, so the bias's true gradient is exactly 0: what either
# package computes for it is rounding noise, which Adam turns into an update
# of about lr with an arbitrary sign (as for BCDUNet's biases before a
# non-affine norm, tests/test_torch_generators.py). It is left out of the
# update comparison, its gradient held to the noise floor, and its update
# taken out of the G loss, which it shifts one for one.
ZERO_GRAD_SHARE = 1e-6
HEAD_BIAS = ("patch_head", "bias")


def _assert_state_close(state, jstate, skip_d=()):
    for model, theirs, net, skip in (
            (state.gen, jstate.g_params, "UNet++", ()),
            (state.disc, jstate.d_params, "patch", skip_d)):
        ours = jax_params_from_state_dict(model.state_dict(), net)
        lo = jax.tree_util.tree_leaves_with_path(ours)
        lt = jax.tree_util.tree_leaves_with_path(theirs["params"])
        assert [p for p, _ in lo] == [p for p, _ in lt]
        kept = [(path, a, b) for (path, a), (_, b) in zip(lo, lt)
                if tuple(k.key for k in path) not in skip]
        assert len(kept) == len(lo) - len(skip)
        for path, a, b in kept:
            assert np.shape(a) == np.shape(b), path
            if np.asarray(a).size >= 256:
                _assert_updates_close(a, b, f"{net} {path}")
        _assert_updates_close(
            np.concatenate([np.ravel(a) for _, a, _ in kept]),
            np.concatenate([np.ravel(b) for _, _, b in kept]),
            f"{net} pooled")


def _head_bias_share(mu_d):
    """|first-step gradient of D's head bias| over the largest of its
    kernel's, from Adam's first moment (a param-shaped JAX tree)."""
    head = mu_d["patch_head"]
    return float(np.abs(head["bias"]).max() / np.abs(head["kernel"]).max())


def check_variant_step(name):
    """Each step of variant ``name`` from the JAX state before it (carried
    with its Adam moments), on the JAX step's draws; under
    --legacy_label_cache the second step injects nothing and must reuse the
    first step's noise."""
    fields, steps = VARIANTS[name]
    r = _jax_variant_steps(fields, steps)
    cfg = _port_cfg(fields)
    step = build_train_step(cfg, multistep_lr(LR, 25, 135, 100))
    assert step.augment == (name == "no_host_aug")
    for i, want in enumerate(r["losses"]):
        state = _port_state(cfg, r["states"][i])
        draws = dict(r["draws"][i])
        if name == "legacy_label_cache" and i > 0:
            draws.pop("label_noise")
        got = step(state, torch.from_numpy(r["src"]),
                   torch.from_numpy(r["tgt"]), apply_gp=True, **draws)
        assert want[3] > 0  # the GP ran
        assert (want[4] > 0) == (name == "version2_pan")
        got, want = got.numpy().copy(), np.array(want)
        after = r["states"][i + 1]
        skip_d = ()
        if name == "loss_w":
            got[1] += float(state.disc.model[11].bias.detach())
            want[1] += float(after.d_params["params"]["patch_head"]["bias"][0])
            skip_d = (HEAD_BIAS,)
            mu_ours = jax_params_from_state_dict(
                {n: state.opt_d.state[p]["exp_avg"]
                 for n, p in state.disc.named_parameters()}, "patch")
            for mu in (mu_ours, after.d_opt_state[0].mu["params"]):
                assert _head_bias_share(mu) < ZERO_GRAD_SHARE
        np.testing.assert_allclose(got, want, rtol=1e-4)
        _assert_state_close(state, after, skip_d)
    if name == "legacy_label_cache":
        (shape, noise), = step.label_cache.items()
        assert shape == tuple(r["pred_shape"])
        assert torch.equal(noise, r["draws"][0]["label_noise"])
        assert torch.equal(noise, r["draws"][1]["label_noise"])
    else:
        assert step.label_cache == {}


# --no-host_aug and --space_to_depth run in test_torch_augment.py and
# test_torch_space_to_depth.py, so that the workers share the JAX compiles.
@pytest.mark.parametrize("name", sorted(set(VARIANTS) - {
    "no_host_aug", "space_to_depth"}))
def test_variant_step_matches_jax(name):
    check_variant_step(name)


def _g_grads(fields, seed=3):
    """G's gradients (taken as Adam sees them) and the losses of one port
    step from seeded weights and injected draws."""
    cfg = _port_cfg(fields)
    gen, disc = networks(cfg)
    for m, s in ((gen, seed), (disc, seed + 1)):
        g = torch.Generator().manual_seed(s)
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.1
                        + (1.0 if p.dim() == 1 and p.numel() > 1 else 0.0))
    state = TrainState(gen, disc, make_optimizer(gen.parameters(), LR, BETA1),
                       make_optimizer(disc.parameters(), LR, BETA1))
    grads = []
    state.opt_g.register_step_pre_hook(lambda *_: grads.extend(
        p.grad.clone() for p in gen.parameters()))
    rng = np.random.default_rng(seed)
    src, tgt = (torch.from_numpy(rng.integers(0, 255, (BATCH, SIZE, SIZE, 3),
                                              np.uint8)) for _ in range(2))
    draws = torch.Generator().manual_seed(seed + 2)
    losses = build_train_step(cfg, multistep_lr(LR, 25, 135, 100))(
        state, src, tgt, apply_gp=True,
        label_noise=torch.randn((BATCH, 9, 9, 1), generator=draws),
        gp_alpha=torch.rand((BATCH, 1, 1, 1), generator=draws))
    return grads, losses


def test_version2_pan_term_gives_g_no_gradient():
    """The detached pan term leaves G's gradients as they are without it
    (lambda_per 0, the same draws): loss_per is logged, trains nothing."""
    with_pan, losses = _g_grads(dict(version=2, lambda_per=1.0))
    without, losses0 = _g_grads(dict(version=2, lambda_per=0.0))
    assert losses[4] > 0 and losses0[4] == 0
    assert torch.equal(losses[:4], losses0[:4])
    assert len(with_pan) == len(without) > 0
    for a, b in zip(with_pan, without):
        assert torch.equal(a, b)


@pytest.mark.parametrize("loss", ["ls", "ce", "w", "hinge"])
def test_the_losses_activations_reach_both_networks(loss):
    """G's Tanh and D's sigmoid only for 'ls', as the JAX config's truth
    table says; ``networks`` (which the trainer and chip_smoke.py use)
    builds both from it."""
    cfg = _port_cfg({"loss": loss})
    assert cfg.activation == JaxTrainConfig(loss=loss).activation == (
        loss == "ls")
    gen, disc = networks(cfg)
    assert gen.downfeature.activation == disc.activation == cfg.activation
    x = torch.full((1, 32, 32, 3), 5.0)
    with torch.no_grad():
        init = torch.Generator().manual_seed(0)
        for p in gen.downfeature.parameters():
            p.copy_(torch.randn(p.shape, generator=init) * 10)
        disc.model[11].bias.fill_(5.0)
        out = gen(x)
        pred, _ = disc(x, x)
    # Without the activations the outputs leave [-1, 1] and [0, 1].
    assert bool(out.abs().max() > 1) != cfg.activation
    assert bool(pred.max() > 1) != cfg.activation
