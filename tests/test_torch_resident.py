"""``--bf16_resident`` and ``--disc_bf16`` in the port against the JAX
package: UNet++ (and its --space_to_depth variant) with bf16 activations in
every row, the PatchGAN's logits and bf16 features, the gradient penalty
through the resident D, one training step with both flags, the same step
under data and tensor parallelism, the gates and ``params.txt``, and the
serving runner, which never builds a resident generator.

Every tolerance against the JAX package is ``FACTOR`` times a floor
measured in the same test: the JAX function against itself with its inputs
(for the step, its weights) scaled by (1 + PERTURB N(0, 1)), two draws,
the larger taken. PERTURB is a quarter of bf16's relative step (2^-8), so
the floor is the spread of bf16 rounding that these modes add; the port
and the JAX package round in other places (the port convolves the
concatenated node input, the JAX package sums per-piece convs in float32)
and land inside it. Each test also asserts that FACTOR x its floor stays
under half of what an unrelated or zero answer would read, so that the
check can fail. The floors as measured on a CPU (``-s`` prints them with
the port's readings): the UNet++ forward's [max, mean] 0.035 / 0.0047
(s2d 0.027 / 0.0027); the PatchGAN's 0.031 / 0.0018; the GP's relative
value 0.0016 and its gradient shares 0.036-0.140; the step (``STEP_STATS``)
loss 0.0096, G angle 0.087 and scale 0.023, D angle 0.0089, scale 0.0026
and flips 0.040. Resident against non-resident is held to the JAX tests'
own 0.05 (``tests/test_models.py``, ``tests/test_disc_perf.py``).
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tactile_gan_tpu.core.config import TrainConfig as JaxTrainConfig
from tactile_gan_tpu.losses.gradient_penalty import (
    gradient_penalty as jax_gradient_penalty,
)
from tactile_gan_tpu.models.factory import (
    create_discriminator as jax_create_discriminator,
    create_generator as jax_create_generator,
)

from test_torch_train import _randomize

from tactile_gan_torch.cli import quality
from tactile_gan_torch.core.config import (
    TPU_ONLY_FLAGS, TrainConfig, config_from_args,
)
from tactile_gan_torch.entry import _phases
from tactile_gan_torch.eval.runner import load_model
from tactile_gan_torch.losses.gradient_penalty import gradient_penalty
from tactile_gan_torch.models.blocks import init_weights
from tactile_gan_torch.models.factory import (
    create_discriminator, create_generator, networks,
)
from tactile_gan_torch.ops.conv import conv_layer
from tactile_gan_torch.parallel.tensor_parallel import full_state_dicts
from tactile_gan_torch.train import graph
from tactile_gan_torch.utils.checkpoint import save_checkpoint
from tactile_gan_torch.utils.convert import (
    jax_params_from_state_dict, state_dict_from_jax,
)

import torch_dist as td

torch.set_num_threads(2)

NF, SIZE, BATCH = 8, 32, 2
D_SIZE = 64  # D at 64x64: a 9x9 patch map
PERTURB = td.PERTURB
FACTOR = 3.0
JAX_OWN = 0.05  # the JAX tests' resident-vs-plain tolerance
LR, BETA1 = 1e-3, 0.9


def _perturbed(a, seed):
    r = np.random.default_rng(seed)
    return (a * (1 + PERTURB * r.standard_normal(a.shape))).astype(np.float32)


def _diffs(a, b):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return np.array([d.max(), d.mean()])


def _floor(fn, inputs):
    """[max, mean] |fn(inputs) - fn(inputs perturbed)|, the larger of two
    draws."""
    want = fn(*inputs)
    return np.max([_diffs(want, fn(*[_perturbed(x, 100 * s + i)
                                     for i, x in enumerate(inputs)]))
                   for s in (1, 2)], axis=0)


def _dtypes(module, names):
    """{name: output dtype} of each named submodule in the next forward."""
    seen = {}
    for name in names:
        module.get_submodule(name).register_forward_hook(
            lambda m, a, out, name=name: seen.__setitem__(name, out.dtype))
    return seen


@pytest.mark.parametrize("s2d", [False, True])
def test_unetpp_forward_matches_jax(s2d):
    """Every node (row 0 and the stem included) hands on bf16; the head
    emits float32 within FACTOR x the JAX floor of the JAX output, and
    within 0.05 of the port's non-resident bf16 forward."""
    x = np.random.default_rng(3).uniform(
        -1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    model = jax_create_generator("UNet++", 3, NF, True,
                                 compute_dtype=jnp.bfloat16,
                                 bf16_resident=True, space_to_depth=s2d)
    params = _randomize(jax.eval_shape(model.init, jax.random.key(0),
                                       jnp.asarray(x)), 5)
    apply = jax.jit(model.apply)
    want = np.asarray(apply(params, x))
    floor = _floor(lambda v: np.asarray(apply(params, v)), [x])
    ours = {}
    for resident in (True, False):
        gen = create_generator("UNet++", nf=NF, compute_dtype=torch.bfloat16,
                               space_to_depth=s2d, bf16_resident=resident)
        gen.load_state_dict(state_dict_from_jax(params, "UNet++"))
        nodes = [n for n, _ in gen.named_children() if n.startswith("conv")]
        seen = _dtypes(gen, nodes)
        with torch.no_grad():
            ours[resident] = gen(torch.from_numpy(x))
        assert ours[resident].dtype == torch.float32
        assert len(seen) == 15 and set(seen.values()) == {
            torch.bfloat16 if resident else torch.float32}
    got = _diffs(ours[True], want)
    print(f"UNet++ s2d={s2d} floor [max, mean]: {floor}, port: {got}")
    assert np.all(floor > 0)
    # a zero output would read the output's own size
    assert np.all(FACTOR * floor < 0.5 * _diffs(want, 0 * want)), floor
    assert np.all(got <= FACTOR * floor), (got, floor)
    assert _diffs(ours[True], ours[False])[0] <= JAX_OWN


def test_resident_kernel_conv_rounds_a_float32_input():
    """Kernel B's output follows its input: a resident kernel conv on a
    float32 input still hands the norm bf16 (the JAX resident conv casts
    to the compute dtype whatever it reads)."""
    conv = torch.nn.Conv2d(8, 8, 3, padding=1, bias=False)
    x = torch.randn(1, 8, 8, 8)
    y = conv_layer(x, conv, compute_dtype=torch.bfloat16, kernel=True,
                   resident=True)
    assert y.dtype == torch.bfloat16
    assert conv_layer(x, conv, compute_dtype=torch.bfloat16,
                      kernel=True).dtype == torch.float32


@pytest.fixture(scope="module")
def disc_setup():
    rng = np.random.default_rng(6)
    a = rng.uniform(-1, 1, (BATCH, D_SIZE, D_SIZE, 3)).astype(np.float32)
    b, fake = (rng.uniform(0, 1, a.shape).astype(np.float32)
               for _ in range(2))
    model = jax_create_discriminator("patch", NF, True,
                                     compute_dtype=jnp.bfloat16,
                                     resident=True)
    params = _randomize(jax.eval_shape(model.init, jax.random.key(1),
                                       jnp.asarray(a), jnp.asarray(b)), 7)
    disc = create_discriminator(nf=NF, compute_dtype=torch.bfloat16,
                                resident=True)
    disc.load_state_dict(state_dict_from_jax(params, "patch"))
    return dict(a=a, b=b, fake=fake, model=model, params=params, disc=disc)


def test_patchgan_logits_and_features_match_jax(disc_setup):
    s = disc_setup
    apply = jax.jit(s["model"].apply)

    def flat(a, b):
        logits, feats = apply(s["params"], a, b)
        return np.concatenate([np.ravel(np.asarray(t, np.float32))
                               for t in (logits,) + tuple(feats)])

    floor = _floor(flat, [s["a"], s["b"]])
    want_logits, want_feats = apply(s["params"], s["a"], s["b"])
    assert all(f.dtype == jnp.bfloat16 for f in want_feats)
    a, b = torch.from_numpy(s["a"]), torch.from_numpy(s["b"])
    with torch.no_grad():
        logits, feats = s["disc"](a, b)
        plain = create_discriminator(nf=NF, compute_dtype=torch.bfloat16)
        plain.load_state_dict(s["disc"].state_dict())
        plain_logits, plain_feats = plain(a, b)
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, 9, 9, 1)
    assert [f.dtype for f in feats] == [torch.bfloat16] * 4
    assert [f.dtype for f in plain_feats] == [torch.float32] * 4
    want = flat(s["a"], s["b"])
    got = _diffs(np.concatenate([np.ravel(t.float().numpy())
                                 for t in (logits,) + tuple(feats)]), want)
    print(f"PatchGAN floor [max, mean]: {floor}, port: {got}")
    assert np.all(floor > 0)
    assert np.all(FACTOR * floor < 0.5 * _diffs(want, 0 * want)), floor
    assert np.all(got <= FACTOR * floor), (got, floor)
    assert _diffs(logits, want_logits)[0] <= FACTOR * floor[0]
    assert _diffs(logits, plain_logits)[0] <= JAX_OWN


def test_gradient_penalty_and_its_gradient_match_jax(disc_setup):
    """The GP's second-order backward through bf16 activations: its value
    within FACTOR x the floor of its relative change, each D gradient
    within FACTOR x the floor of its max|change| / max|gradient|."""
    s = disc_setup
    key = jax.random.key(11)

    def gp_of(p, a, b, fake):
        return jax_gradient_penalty(
            lambda img, mask: s["model"].apply(p, img, mask)[0], a, b, fake,
            key, version=2, lambda_gp=0.01)

    value_and_grad = jax.jit(jax.value_and_grad(gp_of))
    inputs = [s["a"], s["b"], s["fake"]]
    want, want_grads = value_and_grad(s["params"], *inputs)
    leaves = [np.asarray(g) for g in jax.tree.leaves(want_grads["params"])]

    def shares(grads):
        return np.array([np.abs(g - w).max() / np.abs(w).max()
                         for g, w in zip(grads, leaves)])

    floor_value, floor_shares = 0.0, np.zeros(len(leaves))
    for seed in (1, 2):
        v, g = value_and_grad(s["params"], *[
            _perturbed(x, 100 * seed + i) for i, x in enumerate(inputs)])
        floor_value = max(floor_value, abs(float(v) / float(want) - 1))
        floor_shares = np.maximum(floor_shares, shares(
            [np.asarray(t) for t in jax.tree.leaves(g["params"])]))
    alpha = np.array(jax.random.uniform(key, (BATCH, 1, 1, 1), jnp.float32))
    disc = s["disc"]
    gp = gradient_penalty(lambda img, mask: disc(img, mask)[0],
                          *[torch.from_numpy(x) for x in inputs],
                          torch.from_numpy(alpha), version=2, lambda_gp=0.01)
    grads = torch.autograd.grad(gp, list(disc.parameters()))
    print(f"GP floor: value {floor_value}, gradient shares {floor_shares}")
    # a zero penalty or gradient would read 1
    assert FACTOR * floor_value < 0.5 and np.all(FACTOR * floor_shares < 0.5)
    assert gp.dtype == torch.float32 and float(want) > 0
    assert abs(float(gp.detach()) / float(want) - 1) <= FACTOR * floor_value
    ours = jax_params_from_state_dict(
        dict(zip([n for n, _ in disc.named_parameters()], grads)), "patch")
    got = shares([np.asarray(t) for t in jax.tree.leaves(ours)])
    assert np.all(got <= FACTOR * floor_shares), (got, floor_shares)


# The resident step (``td.RESIDENT``: nf 16, 64x64, batch 2, bf16 compute,
# GP, the version-2 pan term on bf16 features) against one JAX step from the
# same weights and draws. A reading: the largest relative difference of the
# five losses; for G and for D, over the whole network, the gradient's
# angle (1 - cos) and scale (|norm ratio - 1|), the gradient read from
# Adam's first moment after the step ((1 - beta1) x gradient); and the share
# of D's parameters whose update differs by more than lr / 2. An unrelated
# answer reads 1 (an orthogonal gradient), 1 (a zero one) and 0.5 (updates
# of random sign): ``STEP_CEILING``. The floor of each statistic must stay
# under half of it, or the check could not fail. G's updates are left out:
# Adam's first update is lr x sign(gradient), and 16% of G's signs flip
# between two bf16 steps (the floor), so 3x that could not fail; G's
# parameters are held through their gradient instead.
STEP_STATS = ("loss", "G angle", "G scale", "D angle", "D scale", "D flips")
STEP_CEILING = np.array([np.inf, 1.0, 1.0, 1.0, 1.0, 0.5])


def _step_reading(ref, losses, after, moments, label=""):
    """The reading of a step from the reference's weights under ``label``
    (``floor{s}/``, or the reference's own) against the reference's step;
    ``after`` and ``moments``: {"gen"|"disc": {name: array}}."""
    row = [np.max(np.abs(np.asarray(losses) / ref["losses"] - 1))]
    for key in ("gen", "disc"):
        names = sorted(k[len(key) + 4:] for k in ref
                       if k.startswith(f"mu_{key}/"))
        a, b = (np.concatenate([np.ravel(m[n]) for n in names]).astype(
            np.float64) for m in (moments[key], {
                n: ref[f"mu_{key}/{n}"] for n in names}))
        norm_a, norm_b = np.linalg.norm(a), np.linalg.norm(b)
        row += [1 - a @ b / (norm_a * norm_b), abs(norm_a / norm_b - 1)]
    d = np.abs(np.concatenate([np.ravel(
        (np.asarray(after["disc"][n]) - ref[f"{label}disc/{n}"])
        - (ref[f"after_disc/{n}"] - ref[f"disc/{n}"])) for n in names]))
    return np.array(row + [(d > 0.5 * LR).mean()])


def _port_reading(ref, losses, sd):
    """The reading of a port step: ``sd`` as ``full_state_dicts`` gives
    it."""
    moments = {}
    for key, opt_key in (("gen", "opt_g"), ("disc", "opt_d")):
        names = list(sd[key])  # the parameters, in the optimizer's order
        moments[key] = {n: sd[opt_key]["state"][i]["exp_avg"].numpy()
                        for i, n in enumerate(names)}
    return _step_reading(ref, losses.numpy(), {
        key: {n: v.numpy() for n, v in sd[key].items()}
        for key in ("gen", "disc")}, moments)


@pytest.fixture(scope="module")
def jax_resident(tmp_path_factory):
    """The JAX resident step and its floor: the JAX step from every weight
    scaled by (1 + PERTURB N(0, 1)) against the JAX step, two seeds, the
    larger reading of each statistic."""
    path = str(tmp_path_factory.mktemp("resident") / "jax_resident.npz")
    td.jax_step_reference(path, resident=True)
    ref = dict(np.load(path))

    def group(prefix):
        return {key: {k[len(prefix) + len(key) + 1:]: v for k, v in
                      ref.items() if k.startswith(f"{prefix}{key}/")}
                for key in ("gen", "disc")}

    floor = np.max([_step_reading(
        ref, ref[f"floor{s}/losses"], group(f"floor{s}/after_"),
        group(f"floor{s}/mu_"), f"floor{s}/") for s in td.FLOOR_SEEDS],
        axis=0)
    print("resident step floor:", dict(zip(STEP_STATS, floor)))
    assert np.all(ref["losses"][3:] > 0)  # the GP and the pan term ran
    assert np.all(floor > 0)
    assert np.all(FACTOR * floor < 0.5 * STEP_CEILING), floor
    return path, ref, floor


def test_train_step_with_both_flags_matches_jax(jax_resident):
    """One step with --bf16_resident --disc_bf16 from the JAX weights and
    draws (one process): every statistic of ``STEP_STATS`` within FACTOR x
    the JAX step's own floor."""
    _, ref, floor = jax_resident
    cfg = td.resident_config()
    state = td.reference_state(ref, cfg)
    assert state.gen.bf16_resident and state.disc.resident
    losses = td.reference_step(ref, state, cfg=cfg)
    got = _port_reading(ref, losses, full_state_dicts(state))
    print("resident step, one process:", dict(zip(STEP_STATS, got)))
    assert np.all(got <= FACTOR * floor), (got, floor)


@pytest.fixture(scope="module")
def parallel_runs(jax_resident, tmp_path_factory):
    """The resident step on 2 gloo ranks from the JAX step's weights and
    draws, DP 2x1 then TP 1x2."""
    path = jax_resident[0]
    root = str(tmp_path_factory.mktemp("resident_ranks"))
    td.spawn(td.resident_rank, 2, root, path, [1, 2])
    return {n: torch.load(os.path.join(root, f"resident_{n}.pt"))
            for n in (1, 2)}


@pytest.mark.parametrize("n_model,split", [
    (1, []), (2, ["conv4_0.layer.0", "conv4_0.layer.3"])])
def test_resident_step_under_dp_and_tp(jax_resident, parallel_runs, n_model,
                                       split):
    """DP 2x1 and TP 1x2 (the 256-channel row split, its activations
    gathered in bf16) against the JAX single-device step: every statistic
    of ``STEP_STATS`` within FACTOR x its floor."""
    _, ref, floor = jax_resident
    res = parallel_runs[n_model]
    assert res["split"] == split
    assert res["gathered"] == (["torch.bfloat16"] if split else [])
    got = _port_reading(ref, res["losses"], res["state"])
    print(f"resident step, mesh {2 // n_model}x{n_model}:",
          dict(zip(STEP_STATS, got)))
    assert np.all(got <= FACTOR * floor), (got, floor)


def test_gates_are_off_without_a_flag_and_a_no_op_in_float32():
    for dtype in ("bfloat16", "float32"):
        cfg = TrainConfig(compute_dtype=dtype)
        assert not cfg.effective_bf16_resident()
        assert not cfg.effective_disc_bf16()
        gen, disc = networks(TrainConfig(compute_dtype=dtype, nf=4))
        assert not gen.bf16_resident and not disc.resident
    on = TrainConfig(bf16_resident=True, disc_bf16=True)
    assert on.effective_bf16_resident() and on.effective_disc_bf16()
    on32 = TrainConfig(bf16_resident=True, disc_bf16=True,
                       compute_dtype="float32")
    assert not on32.effective_bf16_resident()
    assert not on32.effective_disc_bf16()
    off = TrainConfig(bf16_resident=False, disc_bf16=False)
    assert not off.effective_bf16_resident() and not off.effective_disc_bf16()
    # UNet and BCDUNet take no residency, as in the JAX factory.
    assert not hasattr(networks(TrainConfig(gen="UNet", nf=2,
                                            bf16_resident=True))[0],
                       "bf16_resident")
    # float32 compute: the flags change no bit.
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (1, 32, 32, 3)).astype(np.float32))
    outs = []
    for flag in (False, True):
        gen, disc = networks(TrainConfig(compute_dtype="float32", nf=4,
                                         bf16_resident=flag, disc_bf16=flag))
        init_weights(gen, torch.Generator().manual_seed(1))
        init_weights(disc, torch.Generator().manual_seed(2))
        with torch.no_grad():
            y = gen(x)
            outs.append((y, disc(x, y)[0]))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("value", [None, True, False])
def test_params_txt_round_trips_the_flags(tmp_path, value):
    """Either package's params.txt carries the tri-state values; a JAX
    params.txt with bf16_resident true resumes resident."""
    for writer in (TrainConfig, JaxTrainConfig):
        folder = tmp_path / writer.__module__.split(".")[0]
        folder.mkdir()
        writer(bf16_resident=value, disc_bf16=value).save_params(str(folder))
        with open(folder / "params.txt") as f:
            raw = json.load(f)
        assert raw["bf16_resident"] is value and raw["disc_bf16"] is value
        cfg = TrainConfig.from_params_file(str(folder / "params.txt"))
        assert cfg.bf16_resident is value and cfg.disc_bf16 is value
        gen, disc = networks(dataclasses.replace(cfg, nf=2))
        assert gen.bf16_resident is bool(value)
        assert disc.resident is bool(value)


def test_the_tpu_only_note_no_longer_names_the_flags(capsys):
    assert "bf16_resident" not in TPU_ONLY_FLAGS
    assert "disc_bf16" not in TPU_ONLY_FLAGS
    assert "gp_fused" in TPU_ONLY_FLAGS and "lane_pack" in TPU_ONLY_FLAGS
    cfg = config_from_args(["--bf16_resident", "--disc_bf16"])
    assert capsys.readouterr().out == ""
    assert cfg.bf16_resident is True and cfg.disc_bf16 is True
    config_from_args(["--bf16_resident", "--gp_fused"])
    note = capsys.readouterr().out
    assert "--gp_fused" in note and "bf16_resident" not in note
    assert config_from_args(["--no-disc_bf16"]).disc_bf16 is False


def test_serving_a_resident_params_txt_builds_the_float32_resident_generator(
        tmp_path):
    """The JAX serving runner never builds a resident generator: a model
    trained with both flags serves with float32 activations."""
    cfg = TrainConfig(nf=4, bf16_resident=True, disc_bf16=True)
    gen, _ = networks(cfg)
    init_weights(gen, torch.Generator().manual_seed(3))
    path = str(tmp_path / "final_model.pth")
    save_checkpoint(path, gen=gen.state_dict())
    _, served = load_model(path, cfg, device="cpu")
    assert gen.bf16_resident and not served.bf16_resident
    seen = _dtypes(served, ["conv0_0", "conv4_0"])
    with torch.no_grad():
        served(torch.zeros(1, 32, 32, 3))
    assert set(seen.values()) == {torch.float32}


def test_quality_and_the_dry_run_pass_the_flags_on():
    args = quality.parse_args(["--bf16_resident", "--disc_bf16"])
    argv = quality.train_argv(args)
    assert "--bf16_resident" in argv and "--disc_bf16" in argv
    assert args.tag == "quality_b4_v2_resident"
    assert not {"--bf16_resident", "--disc_bf16"} & set(
        quality.train_argv(quality.parse_args([])))
    (_, phase1), (_, phase2) = _phases(2, "/data", "cpu")
    assert not phase1.bf16_resident and not phase1.disc_bf16
    assert phase2.bf16_resident and phase2.disc_bf16
    assert phase2.compute_dtype == "bfloat16"


def test_launch_carry_moves_the_bf16_counts(monkeypatch):
    for module, name in graph.LAUNCH_COUNTERS:
        fn = getattr(module, name)
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "bf16_launches", 0, raising=False)
    per_call = (30, 30, 9, 9, 9, 0, 0)
    with graph.LaunchCarry() as carry:
        graph.add_launches(per_call)
        graph.add_launches(per_call, count="bf16_launches")
    assert graph.read_launches("bf16_launches") == (0,) * 7
    carry.replayed()
    carry.replayed()
    assert graph.read_launches("bf16_launches") == tuple(
        2 * n for n in per_call)
    assert carry.bf16_counts == per_call
