"""The port's training trajectory against the JAX step's over K steps: each
package carries its own state from step to step, across a learning-rate
milestone and both gradient-penalty variants, so a fault that builds up
over steps (the schedule, the GP switch, Adam's state) shows where a check
of one step restarted from the JAX state would not.

K = 6 steps at float32 compute, UNet++ nf 4, batch 2, 64x64, version 2
(pan_loss, as the quality record's b4 and b16 configs), a new uint8 batch
each step. Two steps make an epoch and the schedule has milestones at
epochs 1, 2, ...: the rate is lr, lr x0.8, lr x0.64 over steps 1-2, 3-4,
5-6. The GP runs on epochs divisible by 2 (--reg_every 2): steps 3-4 only.
The port's step gets the JAX step's label noise and GP alpha.

Tolerances, from a measured floor: the port's trajectory again with every
initial weight x (1 + 1e-6 N(0, 1)) (a float32 sum taken in another order)
under seeds 14, 15 and 16, against the port's own. Measured on an x86 CPU,
as max relative difference of each loss over the 6 steps (D, G, L1, GP,
pan) and as the pooled mean |difference| / lr of each network's final
parameters:
                 D       G       L1      GP      pan     G mean  D mean
  floor         1.0e-3  2.4e-3  1.7e-4  6.9e-3  2.2e-3  0.51    0.081
  port vs JAX   6.9e-4  1.6e-3  8.7e-5  2.0e-3  6.9e-4  0.20    0.027
  LOSS_RTOL     3e-3    7e-3    5e-4    2e-2    7e-3
The tiny GAN is chaotic under Adam's first steps (each moves a weight by
about lr times the sign of its gradient), so the floor grows from 1e-6 at
step 1 to 1e-3 by step 3. LOSS_RTOL is 3x the floor. The parameters are
held with the pooled check of test_torch_train.py: fewer than 5% of the
elements off by more than K lr / 2 (its bound scaled by K; the floor puts
at most 0.28% of G's there), and each network's mean under 2.5x its floor,
G 1.3 lr and D 0.2 lr. The bound of test_torch_train.py scaled by K, 0.6
lr, would stand 1.2x above G's floor: a summation order that differs
across CPUs or BLAS builds could fail it, and no planted fault needs it
(each moves a loss or D's mean past its bound). Faults planted in the
port's step (measured the same way): the schedule one milestone late
moves L1 by 2.6e-3 and D's mean to 0.37 lr; the GP never, always, or an
epoch late moves the GP loss by 1 or more and D's mean to 0.59 lr or
more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactile_gan_tpu.core.config import TrainConfig as JaxTrainConfig
from tactile_gan_tpu.models.factory import (
    create_discriminator as jax_create_discriminator,
    create_generator as jax_create_generator,
)
from tactile_gan_tpu.train.schedule import multistep_lr as jax_multistep_lr
from tactile_gan_tpu.train.state import TrainState as JaxTrainState
from tactile_gan_tpu.train.state import make_optimizer as jax_make_optimizer
from tactile_gan_tpu.train.step import build_train_step as jax_build_train_step

from test_torch_train import (
    BETA1, LR, NF, _host, _jax_draws, _port_state, _randomize,
)

from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.train.schedule import multistep_lr
from tactile_gan_torch.train.step import build_train_step
from tactile_gan_torch.utils.convert import (
    patchdisc_jax_params_from_state_dict, unetpp_jax_params_from_state_dict,
)

torch.set_num_threads(2)

K, STEPS_PER_EPOCH, REG_EVERY = 6, 2, 2
SIZE, BATCH = 64, 2
# Milestones at run-epochs 1..10 (np.linspace(1, 11, 11)[:-1]).
EPOCH_CONSTANT, TOTAL_EPOCHS = 1, 11
FIELDS = dict(gen="UNet++", nf=NF, batch_size=BATCH, image_size=SIZE,
              compute_dtype="float32", lr=LR, beta1=BETA1, version=2,
              lambda_per=1.0, epoch_constant=EPOCH_CONSTANT,
              total_epochs=TOTAL_EPOCHS, reg_every=REG_EVERY)
# D, G, L1, GP and pan losses.
LOSS_RTOL = np.array([3e-3, 7e-3, 5e-4, 2e-2, 7e-3])
# Pooled mean |difference| / lr of each network's final parameters.
# 2.5x the floor of each (the docstring's table).
MEAN_BOUND = {"G": 1.3, "D": 0.2}
FLOOR_EPS = 1e-6


def apply_gp(step):
    """The trainer's gate for the 0-based ``step``: epochs count from 1."""
    epoch = step // STEPS_PER_EPOCH + 1
    return epoch % REG_EVERY == 0


def batches():
    rng = np.random.default_rng(61)
    return rng.integers(0, 255, (K, 2, BATCH, SIZE, SIZE, 3), np.uint8)


@pytest.fixture(scope="module")
def jax_trajectory():
    return run_jax()


def run_jax():
    """K JAX steps from one initial state: the initial state, the losses of
    each step, the draws of each step and the final state."""
    cfg = JaxTrainConfig(**FIELDS)
    gen = jax_create_generator("UNet++", 3, NF, activation=True)
    disc = jax_create_discriminator("patch", NF, activation=True)
    sched = jax_multistep_lr(LR, EPOCH_CONSTANT, TOTAL_EPOCHS,
                             STEPS_PER_EPOCH)
    g_tx, d_tx = (jax_make_optimizer(sched, BETA1) for _ in range(2))
    ex = jnp.zeros((BATCH, SIZE, SIZE, 3))
    # Weights from numpy (an op-by-op flax init costs ~40 s here).
    g_params = _randomize(jax.eval_shape(gen.init, jax.random.key(0), ex), 5)
    d_params = _randomize(jax.eval_shape(disc.init, jax.random.key(1), ex,
                                         ex), 6)
    state = JaxTrainState(g_params=g_params, d_params=d_params,
                          g_opt_state=g_tx.init(g_params),
                          d_opt_state=d_tx.init(d_params),
                          step=jnp.zeros((), jnp.int32))
    step = jax_build_train_step(cfg, gen, disc, g_tx, d_tx)
    key = jax.random.key(5)
    first, losses, draws = _host(state), [], []
    for s, (src, tgt) in enumerate(batches()):
        state, m = step(state, jnp.asarray(src), jnp.asarray(tgt), key,
                        apply_gp=apply_gp(s))
        losses.append([float(v) for v in (m.loss_d, m.loss_g, m.loss_l1,
                                          m.loss_gp, m.loss_per)])
        draws.append(_jax_draws(key, s, (BATCH, 9, 9, 1)))
    return dict(first=first, losses=np.array(losses), draws=draws,
                last=_host(state))


def port_trajectory(r, perturb_seed=None):
    """K port steps from the JAX initial state (its weights x (1 + 1e-6 N)
    under ``perturb_seed``), the state carried from step to step: the
    losses of each step and the final state."""
    state = _port_state(r["first"])
    if perturb_seed is not None:
        g = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            for p in [*state.gen.parameters(), *state.disc.parameters()]:
                p.mul_(1 + FLOOR_EPS * torch.randn(p.shape, generator=g))
    step = build_train_step(TrainConfig(**FIELDS, device="cpu"),
                            multistep_lr(LR, EPOCH_CONSTANT, TOTAL_EPOCHS,
                                         STEPS_PER_EPOCH))
    losses = []
    for s, (src, tgt) in enumerate(batches()):
        noise, alpha = r["draws"][s]
        m = step(state, torch.from_numpy(src), torch.from_numpy(tgt),
                 apply_gp=apply_gp(s), label_noise=noise, gp_alpha=alpha)
        losses.append(m.numpy())
    return np.array(losses), state


def param_leaves(state):
    """(G, D) parameter leaves of a port state, as JAX-named trees' leaves."""
    return (jax.tree_util.tree_leaves_with_path(
                unetpp_jax_params_from_state_dict(state.gen.state_dict())),
            jax.tree_util.tree_leaves_with_path(
                patchdisc_jax_params_from_state_dict(
                    state.disc.state_dict())))


def assert_trajectories_close(r, losses, state):
    want = r["losses"]
    # The schedule and the GP switch ran as the test means them to.
    assert [apply_gp(s) for s in range(K)] == [False, False, True, True,
                                               False, False]
    assert np.all(want[2:4, 3] > 0) and np.all(want[[0, 1, 4, 5], 3] == 0)
    assert np.all(want[:, 4] > 0)  # pan_loss ran
    diff = np.abs(losses - want)
    # Where the GP is off both packages give exactly 0: hold the difference.
    rel = np.where(want == 0, diff,
                   diff / np.where(want == 0, 1, np.abs(want)))
    assert np.all(rel.max(axis=0) < LOSS_RTOL), (rel.max(axis=0), LOSS_RTOL)
    ours_g, ours_d = param_leaves(state)
    last = r["last"]
    for ours, theirs, label in (
            (ours_g, last.g_params["params"], "G"),
            (ours_d, last.d_params["params"], "D")):
        lt = jax.tree_util.tree_leaves_with_path(theirs)
        assert [p for p, _ in ours] == [p for p, _ in lt]
        a = np.concatenate([np.ravel(v) for _, v in ours])
        b = np.concatenate([np.ravel(v) for _, v in lt])
        # test_torch_train.py's pooled check; MEAN_BOUND from the floor.
        diff = np.abs(a - b) / LR
        assert diff.mean() < MEAN_BOUND[label], f"{label}: {diff.mean()} lr"
        frac = float((diff > 0.5 * K).mean())
        assert frac < 0.05, f"{label}: {frac:.1%} elements off > K lr/2"
    assert state.step == K


def test_port_trajectory_follows_the_jax_step(jax_trajectory):
    losses, state = port_trajectory(jax_trajectory)
    assert_trajectories_close(jax_trajectory, losses, state)
