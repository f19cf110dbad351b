"""The port's training slice against the JAX package on the same numpy
inputs, weights and random draws: the discriminator, the losses and the
gradient penalty, the VGG tower, the schedule, the data pipeline, one and
two full training steps, and the trainer's artifacts."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from tactile_gan_tpu.core.config import TrainConfig as JaxTrainConfig
from tactile_gan_tpu.data import dataset as jax_dataset
from tactile_gan_tpu.data import host_aug as jax_host_aug
from tactile_gan_tpu.losses.gradient_penalty import (
    gradient_penalty as jax_gradient_penalty,
)
from tactile_gan_tpu.losses.perceptual import (
    vgg_perceptual_loss as jax_vgg_perceptual_loss,
)
from tactile_gan_tpu.models import UNetPlusPlus as JaxUNetPlusPlus
from tactile_gan_tpu.models import vgg as jax_vgg
from tactile_gan_tpu.models.factory import (
    create_discriminator as jax_create_discriminator,
    create_generator as jax_create_generator,
)
from tactile_gan_tpu.ops.pool import max_pool2 as jax_max_pool2
from tactile_gan_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from tactile_gan_tpu.train.schedule import multistep_lr as jax_multistep_lr
from tactile_gan_tpu.train.state import create_train_state
from tactile_gan_tpu.train.state import make_optimizer as jax_make_optimizer
from tactile_gan_tpu.train.step import build_train_step as jax_build_train_step
from tactile_gan_tpu.utils import checkpoint as jax_checkpoint
from tactile_gan_tpu.utils.torch_migrate import patchdisc_from_torch

from tactile_gan_torch.cli import train as port_cli
from tactile_gan_torch.core.config import TrainConfig, config_from_args
from tactile_gan_torch.data import dataset as port_dataset
from tactile_gan_torch.data.prefetch import Prefetcher
from tactile_gan_torch.data.host_aug import augment_pair_np
from tactile_gan_torch.losses.gan_loss import gan_loss
from tactile_gan_torch.losses.gradient_penalty import gradient_penalty
from tactile_gan_torch.losses.perceptual import vgg_perceptual_loss
from tactile_gan_torch.models.patch_discriminator import PatchDiscriminator
from tactile_gan_torch.models.unet_plusplus import UNetPlusPlus
from tactile_gan_torch.models.vgg import load_vgg_features
from tactile_gan_torch.ops.pool import max_pool2
from tactile_gan_torch.ops.resize import resize_bilinear
from tactile_gan_torch.train.loop import Trainer
from tactile_gan_torch.train.schedule import multistep_lr
from tactile_gan_torch.train.state import TrainState, make_optimizer
from tactile_gan_torch.train.step import build_train_step
from tactile_gan_torch.utils.checkpoint import load_checkpoint
from tactile_gan_torch.utils.convert import (
    adam_moments, load_adam_state, patchdisc_jax_params_from_state_dict,
    patchdisc_state_dict_from_jax, unetpp_jax_params_from_state_dict,
    unetpp_state_dict_from_jax,
)

torch.set_num_threads(2)

NF = 4
LR, BETA1 = 1e-3, 0.9


def _randomize(tree, seed, scale=0.1):
    """Every leaf of a flax param tree from numpy: kernels and biases
    N(0, scale), norm scales 1 + N(0, scale)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        v = rng.normal(size=leaf.shape) * scale
        if path[-1].key == "scale":
            v = v + 1.0
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _disc_params(seed, size=64):
    model = jax_create_discriminator("patch", NF, activation=True)
    ex = jnp.zeros((1, size, size, 3))
    return _randomize(model.init(jax.random.key(0), ex, ex), seed)


def _port_disc(params, activation=True):
    d = PatchDiscriminator(nf=NF, activation=activation)
    d.load_state_dict(patchdisc_state_dict_from_jax(params), strict=True)
    return d


def _images(seed, n=2, size=64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32))


# ---------------------------------------------------------------------------
# Discriminator, losses, gradient penalty.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation", [True, False])
def test_discriminator_and_features_match_jax(activation):
    params = _disc_params(3)
    a, b = _images(4)
    jm = jax_create_discriminator("patch", NF, activation=activation)
    want, want_feats = jm.apply(params, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got, feats = _port_disc(params, activation)(torch.from_numpy(a),
                                                    torch.from_numpy(b))
    assert got.shape == want.shape == (2, 9, 9, 1)
    # float32 sums in another order; the deepest norms see 11x11 maps.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    assert len(feats) == len(want_feats) == 4
    for f, w in zip(feats, want_feats):
        np.testing.assert_allclose(f.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-5)


def test_discriminator_state_dict_reads_through_jax_migration():
    params = _disc_params(5)
    sd = _port_disc(params).state_dict()
    assert sorted(sd) == sorted(
        f"model.{i}.{k}" for i, ks in ((0, "wb"), (2, "w"), (3, "wb"),
                                       (5, "w"), (6, "wb"), (8, "w"),
                                       (9, "wb"), (11, "wb"))
        for k in ("weight", "bias")[:len(ks)])
    via_migrate = patchdisc_from_torch({k: v.numpy() for k, v in sd.items()})
    via_port = patchdisc_jax_params_from_state_dict(sd)
    flat = jax.tree_util.tree_leaves_with_path(params["params"])
    for other in (via_migrate, via_port):
        other_flat = jax.tree_util.tree_leaves_with_path(other)
        assert [p for p, _ in flat] == [p for p, _ in other_flat]
        for (_, x), (_, y) in zip(flat, other_flat):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("version", [1, 2])
def test_gradient_penalty_and_its_d_gradient_match_jax(version):
    params = _disc_params(7)
    a, b = _images(8)
    fake = np.random.default_rng(9).uniform(0, 1, b.shape).astype(np.float32)
    key = jax.random.key(11)
    jm = jax_create_discriminator("patch", NF, activation=True)

    def gp_of(p):
        return jax_gradient_penalty(
            lambda img, mask: jm.apply(p, img, mask)[0], jnp.asarray(a),
            jnp.asarray(b), jnp.asarray(fake), key, version=version,
            lambda_gp=0.01)

    want, want_grads = jax.value_and_grad(gp_of)(params)
    # The JAX penalty's own alpha draw, handed to the port.
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))
    disc = _port_disc(params)
    gp = gradient_penalty(lambda img, mask: disc(img, mask)[0],
                          torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(fake), torch.tensor(alpha),
                          version=version, lambda_gp=0.01)
    grads = torch.autograd.grad(gp, list(disc.parameters()))
    # Second-order float32 sums in another order.
    np.testing.assert_allclose(float(gp.detach()), float(want), rtol=1e-4)
    got = patchdisc_jax_params_from_state_dict(
        dict(zip([n for n, _ in disc.named_parameters()], grads)))
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_leaves_with_path(want_grads["params"]),
            jax.tree_util.tree_leaves_with_path(got)):
        scale = np.abs(np.asarray(w)).max()
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4 * scale,
                                   rtol=1e-3, err_msg=str(path))


@pytest.mark.parametrize("mode", ["ls", "ce", "w", "hinge"])
def test_gan_losses_match_jax_with_injected_noise(mode):
    from tactile_gan_tpu.losses.gan_loss import gan_loss as jax_gan_loss

    rng = np.random.default_rng(13)
    logits = rng.normal(size=(2, 9, 9, 1)).astype(np.float32)
    if mode == "ls":
        logits = 1 / (1 + np.exp(-logits))
    key = jax.random.key(17)
    noise = np.asarray(jax.random.normal(key, logits.shape, jnp.float32))
    # (target_is_real, for_discriminator); the generator's hinge loss only
    # aims for real.
    cases = [(True, True), (False, True), (True, False)]
    if mode != "hinge":
        cases.append((False, False))
    for real, for_d in cases:
        for smooth in (False, True):
            want = jax_gan_loss(jnp.asarray(logits), real, mode=mode,
                                for_discriminator=for_d,
                                label_smoothing=smooth, key=key)
            got = gan_loss(torch.from_numpy(logits), real, mode=mode,
                           for_discriminator=for_d, label_smoothing=smooth,
                           noise=torch.from_numpy(noise))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-7)
    if mode == "hinge":
        with pytest.raises(ValueError):
            gan_loss(torch.from_numpy(logits), False, mode=mode,
                     for_discriminator=False)


def test_resize_bilinear_and_max_pool_match_jax():
    x = np.random.default_rng(19).normal(size=(2, 10, 14, 3)).astype(np.float32)
    for size in ((224, 224), (7, 5), (10, 14), (3, 20)):
        np.testing.assert_allclose(
            resize_bilinear(torch.from_numpy(x), size).numpy(),
            np.asarray(jax_resize_bilinear(jnp.asarray(x), size)),
            atol=1e-6, rtol=1e-6)  # the same lerps, float32
    np.testing.assert_array_equal(max_pool2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_max_pool2(jnp.asarray(x))))
    with pytest.raises(ValueError):
        max_pool2(torch.zeros(1, 3, 4, 2))


def _jax_vgg_tower():
    """The JAX package's random fallback tower, and the port's copy of it."""
    jt = jax_vgg.load_vgg_features("")
    pt = {}
    for k, v in jt.items():
        v = np.asarray(v)
        if k.endswith(".kernel"):
            pt[k.replace(".kernel", ".weight")] = torch.from_numpy(
                np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
        else:
            pt[k] = torch.from_numpy(v)
    return jt, pt


def test_vgg_perceptual_loss_matches_jax_tower():
    jt, pt = _jax_vgg_tower()
    a, b = _images(23, size=32)
    w = (0.0, 0.1, 0.3, 0.6)
    want = jax_vgg_perceptual_loss(jax_vgg.vgg_features_apply, jt,
                                   jnp.asarray(b), jnp.asarray(a * 0.5 + 0.5),
                                   weights=w, resize=False)
    got = vgg_perceptual_loss(pt, torch.from_numpy(b),
                              torch.from_numpy(a * 0.5 + 0.5), weights=w,
                              resize=False)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_vgg_fallback_tower_is_seeded_and_shaped_like_the_npz(tmp_path):
    a, b = load_vgg_features(), load_vgg_features()
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k])
    _, jax_port = _jax_vgg_tower()
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: tuple(v.shape) for k, v in jax_port.items()}
    path = os.path.join(str(tmp_path), "vgg.npz")
    np.savez(path, **{k: v.numpy() for k, v in jax_port.items()})
    loaded = load_vgg_features(path)
    for k in loaded:
        assert torch.equal(loaded[k], jax_port[k])


def test_schedule_matches_jax_over_steps():
    for ec, te, spe, off in ((25, 135, 7, 0), (1, 2, 3, 0), (10, 40, 5, 12)):
        ours = multistep_lr(LR, ec, te, spe, step_offset=off)
        theirs = jax_multistep_lr(LR, ec, te, spe, step_offset=off)
        for s in range(off, off + te * spe + spe):
            assert ours(s) == pytest.approx(float(theirs(s)), rel=1e-7)


# ---------------------------------------------------------------------------
# Data: host augmentation and batches.
# ---------------------------------------------------------------------------

def test_host_augmentation_is_byte_equal_to_jax():
    rng = np.random.default_rng(29)
    src = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    tgt = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    for seed in range(12):
        ours = augment_pair_np(src, tgt, np.random.default_rng((7, seed, 1)))
        theirs = jax_host_aug.augment_pair_np(
            src, tgt, np.random.default_rng((7, seed, 1)))
        for a, b in zip(ours, theirs):
            assert a.dtype == np.uint8 and np.array_equal(a, b)


def _write_train_pairs(root, n, size, seed=0):
    rng = np.random.default_rng(seed)
    src_dir = os.path.join(root, "train", "source")
    tac_dir = os.path.join(root, "train", "tactile")
    os.makedirs(src_dir, exist_ok=True)
    os.makedirs(tac_dir, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
                        ).save(os.path.join(src_dir, f"s_{i:04d}.png"))
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
                        ).save(os.path.join(tac_dir, f"t_{i:04d}.tiff"))
    return src_dir


@pytest.mark.parametrize("drop_last,pad", [(True, False), (False, True)])
def test_batches_are_byte_equal_to_jax(tmp_path, drop_last, pad):
    src_dir = _write_train_pairs(str(tmp_path), n=5, size=16)
    ours = port_dataset.PairedDataset(src_dir, size=16, mode="train", aug=True)
    theirs = jax_dataset.PairedDataset(src_dir, size=16, mode="train", aug=True)
    kw = dict(shuffle=True, seed=22, drop_last=drop_last, pad_to_batch=pad,
              threads=2, host_augment=True, augment_seed=21 + 7919)
    got = list(ours.batches(2, **kw))
    want = list(theirs.batches(2, **kw))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for (s, t, v), (s2, t2, v2) in zip(got, want):
        assert v == v2 and s.dtype == np.uint8
        assert np.array_equal(s, s2) and np.array_equal(t, t2)


@pytest.mark.parametrize("drop_last,pad", [(True, False), (False, True)])
def test_prefetcher_yields_the_jax_batches(tmp_path, drop_last, pad):
    """The trainer's input path on the CPU: the dataset's batches through
    data/prefetch.py, byte-equal to the JAX loader's, in its order."""
    src_dir = _write_train_pairs(str(tmp_path), n=5, size=16)
    ours = port_dataset.PairedDataset(src_dir, size=16, mode="train", aug=True)
    theirs = jax_dataset.PairedDataset(src_dir, size=16, mode="train", aug=True)
    kw = dict(shuffle=True, seed=23, drop_last=drop_last, pad_to_batch=pad,
              threads=2, host_augment=True, augment_seed=22 + 7919)
    got = list(Prefetcher(torch.device("cpu"))(ours.batches(2, **kw)))
    want = list(theirs.batches(2, **kw))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for (s, t, v), (s2, t2, v2) in zip(got, want):
        assert v == v2 and s.dtype == t.dtype == torch.uint8
        assert np.array_equal(s.numpy(), s2) and np.array_equal(t.numpy(), t2)


# ---------------------------------------------------------------------------
# One and two training steps against the JAX step, on injected draws.
# ---------------------------------------------------------------------------

STEP_SIZE, STEP_BATCH = 64, 2


def _jax_draws(key, step, shape):
    k_step = jax.random.fold_in(key, step)
    noise = jax.random.normal(jax.random.fold_in(k_step, 3), shape, jnp.float32)
    alpha = jax.random.uniform(jax.random.fold_in(k_step, 4),
                               (shape[0], 1, 1, 1), jnp.float32)
    return torch.from_numpy(np.asarray(noise)), torch.from_numpy(np.asarray(alpha))


def _host(tree):
    return jax.tree.map(lambda v: np.array(v), jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_two_steps():
    """Two JAX steps at float32 compute, GP on, v1 perceptual loss on (the
    JAX fallback tower) and label smoothing on; the states before and after
    each step, the losses and the draws."""
    cfg = JaxTrainConfig(gen="UNet++", nf=NF, batch_size=STEP_BATCH,
                         image_size=STEP_SIZE, compute_dtype="float32",
                         lr=LR, beta1=BETA1)
    gen = jax_create_generator("UNet++", 3, NF, activation=True)
    disc = jax_create_discriminator("patch", NF, activation=True)
    sched = jax_multistep_lr(LR, cfg.epoch_constant, cfg.total_epochs, 100)
    g_tx, d_tx = jax_make_optimizer(sched, BETA1), jax_make_optimizer(sched, BETA1)
    jt, pt = _jax_vgg_tower()
    ex = jnp.zeros((STEP_BATCH, STEP_SIZE, STEP_SIZE, 3))
    state = create_train_state(gen, disc, ex, ex, jax.random.key(3), g_tx, d_tx)
    step = jax_build_train_step(cfg, gen, disc, g_tx, d_tx,
                                vgg_apply=jax_vgg.vgg_features_apply,
                                vgg_params=jt)
    rng = np.random.default_rng(41)
    src = rng.integers(0, 255, (STEP_BATCH, STEP_SIZE, STEP_SIZE, 3), np.uint8)
    tgt = rng.integers(0, 255, (STEP_BATCH, STEP_SIZE, STEP_SIZE, 3), np.uint8)
    key = jax.random.key(5)
    states, losses = [_host(state)], []
    for _ in range(2):
        state, m = step(state, jnp.asarray(src), jnp.asarray(tgt), key,
                        apply_gp=True)
        states.append(_host(state))
        losses.append([float(v) for v in (m.loss_d, m.loss_g, m.loss_l1,
                                          m.loss_gp, m.loss_per)])
    draws = [_jax_draws(key, s, (STEP_BATCH, 9, 9, 1)) for s in range(2)]
    return dict(states=states, losses=losses, draws=draws, vgg=pt, src=src,
                tgt=tgt)


def _port_state(jstate):
    """The port's TrainState from a host copy of a JAX TrainState, Adam
    moments included."""
    gen = UNetPlusPlus(nf=NF, compute_dtype=torch.float32)
    gen.load_state_dict(unetpp_state_dict_from_jax(jstate.g_params))
    disc = PatchDiscriminator(nf=NF)
    disc.load_state_dict(patchdisc_state_dict_from_jax(jstate.d_params))
    opt_g = make_optimizer(gen.parameters(), LR, BETA1)
    opt_d = make_optimizer(disc.parameters(), LR, BETA1)
    step = int(jstate.step)
    if step:
        for opt, model, ost, conv in (
                (opt_g, gen, jstate.g_opt_state, unetpp_state_dict_from_jax),
                (opt_d, disc, jstate.d_opt_state,
                 patchdisc_state_dict_from_jax)):
            adam = ost[0]
            load_adam_state(opt, model, adam.mu, adam.nu, int(adam.count),
                            conv)
    return TrainState(gen, disc, opt_g, opt_d, step=step)


def _assert_updates_close(ours, theirs, label):
    """Adam's early steps move each weight by about lr * sign(grad), so
    elements whose gradient is near zero turn float noise into differences
    up to 2 lr: compare statistically (tests/test_step_parity.py)."""
    diff = np.abs(np.asarray(ours) - np.asarray(theirs))
    assert diff.mean() < 0.1 * LR, f"{label}: mean diff {diff.mean()}"
    frac_big = float((diff > 0.5 * LR).mean())
    assert frac_big < 0.05, f"{label}: {frac_big:.1%} elements off > lr/2"


def _port_step(jax_two_steps, i, state=None, schedule=None):
    r = jax_two_steps
    state = state or _port_state(r["states"][i])
    cfg = TrainConfig(nf=NF, batch_size=STEP_BATCH, image_size=STEP_SIZE,
                      compute_dtype="float32", lr=LR, beta1=BETA1,
                      device="cpu")
    step = build_train_step(cfg, schedule or multistep_lr(LR, 25, 135, 100),
                            r["vgg"])
    noise, alpha = r["draws"][i]
    m = step(state, torch.from_numpy(r["src"]), torch.from_numpy(r["tgt"]),
             apply_gp=True, label_noise=noise, gp_alpha=alpha)
    return state, m.numpy()


def _check_step(jax_two_steps, i, state=None, schedule=None):
    state, got = _port_step(jax_two_steps, i, state, schedule)
    want = np.asarray(jax_two_steps["losses"][i])
    assert np.all(want[3:] > 0)  # GP and perceptual terms really ran
    np.testing.assert_allclose(got, want, rtol=1e-4)
    after = jax_two_steps["states"][i + 1]
    ours_g = unetpp_jax_params_from_state_dict(state.gen.state_dict())
    ours_d = patchdisc_jax_params_from_state_dict(state.disc.state_dict())
    for ours, theirs, label in ((ours_g, after.g_params["params"], "G"),
                                (ours_d, after.d_params["params"], "D")):
        lo = jax.tree_util.tree_leaves_with_path(ours)
        lt = jax.tree_util.tree_leaves_with_path(theirs)
        assert [p for p, _ in lo] == [p for p, _ in lt]
        for (path, a), (_, b) in zip(lo, lt):
            if np.asarray(a).size >= 256:
                _assert_updates_close(a, b, f"{label} {path}")
        _assert_updates_close(
            np.concatenate([np.ravel(a) for _, a in lo]),
            np.concatenate([np.ravel(b) for _, b in lt]), f"{label} pooled")
    assert state.step == i + 1


def test_one_train_step_matches_jax(jax_two_steps):
    _check_step(jax_two_steps, 0)


def test_second_train_step_from_the_carried_jax_state_matches_jax(
        jax_two_steps):
    """Step 2 starts from the JAX state after step 1, carried into the port
    through utils/convert.py with its Adam moments and count."""
    _check_step(jax_two_steps, 1)


def test_trainer_resumes_from_a_jax_msgpack_checkpoint(jax_two_steps,
                                                      tmp_path):
    """--continue_training from the JAX state after step 1, written by the
    JAX package as msgpack: the port's Trainer restores the weights, both
    Adam states and the step, and its next step matches JAX step 2."""
    root = str(tmp_path)
    after_one = jax_two_steps["states"][1]
    jax_checkpoint.save_checkpoint(
        os.path.join(root, "models", "jax", "final_model.pth"),
        gen=after_one.g_params, disc=after_one.d_params,
        opt_g=after_one.g_opt_state, opt_d=after_one.d_opt_state,
        step=int(after_one.step))
    _write_train_pairs(os.path.join(root, "data"), n=STEP_BATCH,
                       size=STEP_SIZE)
    cfg = config_from_args([
        "--data", os.path.join(root, "data"), "--nf", str(NF), "--batch_size", str(STEP_BATCH), "--image_size",
        str(STEP_SIZE), "--compute_dtype", "float32", "--lr", str(LR),
        "--beta1", str(BETA1), "--continue_training", "--folder_load", "jax",
        "--device", "cpu"])
    trainer = Trainer(cfg, port_dataset.PairedDataset(
        os.path.join(root, "data", "train", "source"), mode="train"))
    assert trainer.state.step == trainer.step_offset == 1
    assert all(int(trainer.state.opt_g.state[p]["step"]) == 1
               for p in trainer.gen.parameters())
    _check_step(jax_two_steps, 1, trainer.state, trainer.schedule)


def test_adam_state_round_trips_through_convert(jax_two_steps):
    jstate = jax_two_steps["states"][1]
    state = _port_state(jstate)
    mu, nu, count = adam_moments(state.opt_d, state.disc,
                                 patchdisc_jax_params_from_state_dict)
    adam = jstate.d_opt_state[0]
    assert count == int(adam.count) == 1
    for ours, theirs in ((mu, adam.mu["params"]), (nu, adam.nu["params"])):
        for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ours),
                                  jax.tree_util.tree_leaves_with_path(theirs)):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The trainer, its artifacts and its CLI.
# ---------------------------------------------------------------------------

def _run(root, epochs=2, extra=()):
    """cli.train on 4 pairs at 32x32, batch 2, nf 4, on the CPU."""
    os.makedirs(root, exist_ok=True)
    if not os.path.isdir(os.path.join(root, "data")):
        _write_train_pairs(os.path.join(root, "data"), n=4, size=32, seed=3)
    return port_cli.main([
        "--data", os.path.join(root, "data"), "--nf", str(NF),
        "--batch_size", "2", "--image_size", "32", "--total_epochs",
        str(epochs), "--epoch_constant", "1", "--lambda_per", "0",
        "--compute_dtype", "float32", "--threads", "2", "--folder_save", "m",
        "--device", "cpu", *extra])


def _train(root, epochs=2, extra=()):
    return _run(root, epochs, extra).cfg.models_dir()


def test_trainer_writes_artifacts_that_jax_loads(tmp_path, capsys):
    path = _train(str(tmp_path))
    out = capsys.readouterr().out
    assert "==training epoch 2" in out
    assert sorted(os.listdir(path)) == sorted(
        ["final_model.pth", "params.txt"]
        + [f"{k}loss.npy" for k in ("gen", "disc", "l1", "per", "gp")])
    for k in ("gen", "disc", "l1", "per", "gp"):
        arr = np.load(os.path.join(path, f"{k}loss.npy"))
        assert arr.shape == (2,) and np.all(np.isfinite(arr))
    assert np.all(np.load(os.path.join(path, "gploss.npy")) > 0)
    cfg = JaxTrainConfig.from_params_file(os.path.join(path, "params.txt"))
    assert (cfg.nf, cfg.total_epochs, cfg.compute_dtype) == (NF, 2, "float32")

    ckpt_path = os.path.join(path, "final_model.pth")
    ours = load_checkpoint(ckpt_path)
    assert {"gen", "disc", "optimizerG_state_dict", "optimizerD_state_dict",
            "step"} <= set(ours)
    assert ours["step"] == 4  # 2 epochs x 2 steps
    theirs = jax_checkpoint.load_checkpoint(ckpt_path)
    gen = UNetPlusPlus(nf=NF)
    gen.load_state_dict(ours["gen"])
    disc = PatchDiscriminator(nf=NF)
    disc.load_state_dict(ours["disc"])
    a, b = _images(31, size=32)
    with torch.no_grad():
        got_g = gen(torch.from_numpy(a)).numpy()
        got_d = disc(torch.from_numpy(a), torch.from_numpy(b))[0].numpy()
    want_g = JaxUNetPlusPlus(output_dim=3, nf=NF).apply(
        {"params": theirs["gen"]["params"]}, jnp.asarray(a))
    want_d, _ = jax_create_discriminator("patch", NF).apply(
        {"params": theirs["disc"]["params"]}, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got_g, np.asarray(want_g), atol=5e-5)
    np.testing.assert_allclose(got_d, np.asarray(want_d), atol=2e-5,
                               rtol=1e-5)


def test_continue_training_resumes_from_the_port_checkpoint(tmp_path):
    root = str(tmp_path)
    _train(root, epochs=1)
    first = load_checkpoint(os.path.join(root, "models", "m",
                                         "final_model.pth"))
    _train(root, epochs=1, extra=("--continue_training", "--folder_load", "m"))
    second = load_checkpoint(os.path.join(root, "models", "m",
                                          "final_model.pth"))
    assert (first["step"], second["step"]) == (2, 4)
    step = second["optimizerG_state_dict"]["state"][0]["step"]
    assert int(step) == 4


def test_checkpoint_interval_writes_each_epochs_state(tmp_path):
    """--checkpoint_interval 1 over two epochs: model_1.pth and
    model_2.pth in checkpoints/m hold the state after epochs 1 and 2 (a
    one-epoch run from the same seed, and the trainer's final state), and
    the JAX package reads them."""
    trainer = _run(str(tmp_path / "two"), 2, ("--checkpoint_interval", "1"))
    folder = os.path.join(str(tmp_path / "two"), "checkpoints", "m")
    assert sorted(os.listdir(folder)) == ["model_1.pth", "model_2.pth"]
    one = _run(str(tmp_path / "one"), 1)
    for name, model, step in (("model_1.pth", one.gen, 2),
                              ("model_2.pth", trainer.gen, 4)):
        ckpt = load_checkpoint(os.path.join(folder, name))
        assert ckpt["step"] == step
        sd = model.state_dict()
        assert set(ckpt["gen"]) == set(sd)
        assert all(torch.equal(ckpt["gen"][k], v) for k, v in sd.items())
        theirs = jax_checkpoint.load_checkpoint(os.path.join(folder, name))
        ours = unetpp_jax_params_from_state_dict(ckpt["gen"])
        for (_, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(ours),
                jax.tree_util.tree_leaves_with_path(theirs["gen"]["params"])):
            assert np.array_equal(a, np.asarray(b))
    final = load_checkpoint(os.path.join(trainer.cfg.models_dir(),
                                         "final_model.pth"))
    assert all(torch.equal(final["gen"][k], v) for k, v in
               load_checkpoint(os.path.join(folder, "model_2.pth"))
               ["gen"].items())


def test_train_cli_flags(tmp_path, capsys):
    cfg = config_from_args(["--lane_pack", "--mesh_data", "2", "--nf", "8"])
    note = capsys.readouterr().out
    # The mesh flags shape a parallel run (tests/test_torch_parallel.py).
    assert "ignored" in note and "--lane_pack" in note
    assert "--mesh_data" not in note and cfg.mesh_data == 2
    assert cfg.nf == 8 and cfg.device == "cuda"
    # The variants train for 2 epochs.
    for i, flag in enumerate((["--space_to_depth"], ["--no-host_aug"],
                              ["--legacy_label_cache"],
                              ["--version", "2", "--lambda_per", "1"])):
        trainer = _run(str(tmp_path / f"variant{i}"), extra=flag)
        per = np.load(os.path.join(trainer.cfg.models_dir(), "perloss.npy"))
        assert per.shape == (2,) and np.all(np.isfinite(
            trainer.gen_loss + trainer.disc_loss + trainer.l1_loss))
        assert np.all(per > 0) == (flag[0] == "--version")
    # --ckpt_backend orbax writes step checkpoints through
    # torch.distributed.checkpoint (tests/test_torch_dist_ckpt.py).
    _train(str(tmp_path), extra=("--ckpt_backend", "orbax",
                                 "--checkpoint_interval", "1"))
    orbax = os.path.join(str(tmp_path), "checkpoints", "m", "orbax")
    assert sorted(os.listdir(orbax)) == ["2", "4"]
    assert os.path.exists(os.path.join(orbax, "4", ".metadata"))
    # --checkpoint_interval is ported: 2 epochs at interval 5 write no
    # checkpoint, and the folder exists all the same, as in the JAX loop.
    root = str(tmp_path / "interval")
    _train(root, extra=["--checkpoint_interval", "5"])
    assert os.listdir(os.path.join(root, "checkpoints", "m")) == []
    if not torch.cuda.is_available():
        cfg = TrainConfig(data=os.path.join(str(tmp_path), "data"))
        ds = port_dataset.PairedDataset(
            os.path.join(cfg.data, "train", "source"), mode="train")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg, ds)


def test_continue_training_help_is_the_jax_packages():
    """The trainer resumes both packages' final_model.pth, so the flag says
    what the JAX flag says."""
    from tactile_gan_tpu.core.config import build_arg_parser as jax_parser
    from tactile_gan_torch.core.config import build_arg_parser

    def help_of(parser):
        action, = [a for a in parser._actions
                   if "--continue_training" in a.option_strings]
        return action.help

    assert help_of(build_arg_parser()) == help_of(jax_parser())
    assert help_of(jax_parser()) == "load pretrained weights before training"


def test_profile_families_tell_the_training_kernels_apart():
    from tactile_gan_torch.utils import profiling

    names = {
        "void (anonymous namespace)::in_act_bwd_kernel<__nv_bfloat16>(...)":
            "kernel_c",
        "void (anonymous namespace)::in_act_bwd_kernel<float>(...)": "kernel_c",
        "void (anonymous namespace)::in_act_fwd_kernel<float>(...)": "kernel_a",
        "void (anonymous namespace)::conv3x3_dgrad_sm90_kernel<float, 64>(...)":
            "kernel_b_dx",
        "void (anonymous namespace)::conv3x3_fwd_sm90_kernel<float, 64>(...)":
            "kernel_b",
        "void (anonymous namespace)::conv3x3_wgrad_sm90_kernel<float>(...)":
            "kernel_d",
        "void (anonymous namespace)::wgrad_reduce_kernel(...)": "kernel_d",
        "sm90_xmma_dgrad_implicit_gemm_bf16bf16": "library_conv",
        "void at::native::multi_tensor_apply_kernel<...>(...)": "other"}
    for name, family in names.items():
        assert profiling.kernel_family(name) == family, name
