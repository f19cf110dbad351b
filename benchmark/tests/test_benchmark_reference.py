"""The reference against the port at a tiny size on the CPU: the networks'
forwards, the perceptual loss and the data layer agree, and each cell's
whole run, at float32 compute, comes out correct under its limits. The
shared layers match ``torch.nn``'s; the networks are found by name; the
work counts and weights that the metrics and the check read are pinned."""

import hashlib
import json
import math

import numpy as np
import pytest
import torch
from torch import nn

from benchmark.core.runner import run
from benchmark.core.spec import load_cell
from benchmark.core.weights import load_into, network_weights, vgg_weights
from benchmark.reference import models as ref_models
from benchmark.reference.data import epoch_batches
from benchmark.reference.flops import generator_norm_shapes, step_flops
from benchmark.reference.follow import networks
from benchmark.reference.networks import find, table
from benchmark.reference.step import vgg_perceptual
from benchmark.tests.conftest import ROOT, WORKLOADS
from benchmark.traffic_gen.synth import write_dataset


def _port_generators():
    """The reference's generators that the port's factory builds."""
    from tactile_gan_torch.models.factory import GENERATORS

    return sorted(name for name, e in table().items()
                  if e.role == "gen" and name.lower() in GENERATORS)


def _pair(gen, nf, seed):
    from tactile_gan_torch.models.factory import (
        create_discriminator, create_generator,
    )
    port_g = create_generator(gen, nf=nf)
    port_d = create_discriminator(nf=nf)
    ref_g = find(gen, "gen").network(nf=nf)
    ref_d = find("PatchGAN", "disc").network(nf=nf)
    for port, ref, stream in ((port_g, ref_g, "gen"), (port_d, ref_d,
                                                        "disc")):
        w = network_weights(ref, seed, stream, "cpu")
        # Off the initialization, so the norms' affine parameters count.
        gen_ = torch.Generator().manual_seed(seed)
        w = {k: v + 0.1 * torch.randn(v.shape, generator=gen_)
             for k, v in w.items()}
        load_into(port, w)
        load_into(ref, w)
    return port_g, port_d, ref_g, ref_d


@pytest.mark.parametrize("gen", _port_generators())
def test_forwards_match_the_port(gen):
    size = find(gen, "gen").cpu_test_size
    port_g, port_d, ref_g, ref_d = _pair(gen, 8, 3)
    x = torch.rand((2, size, size, 3), generator=torch.Generator()
                   .manual_seed(1)) * 2 - 1
    with torch.no_grad():
        want = ref_g(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = port_g(x)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        logits, feats = port_d(x, got)
        r_logits, r_feats = ref_d(x.permute(0, 3, 1, 2),
                                  want.permute(0, 3, 1, 2))
        torch.testing.assert_close(logits, r_logits.permute(0, 2, 3, 1),
                                   rtol=1e-4, atol=1e-5)
        for f, r in zip(feats, r_feats):
            torch.testing.assert_close(f, r.permute(0, 2, 3, 1), rtol=1e-4,
                                       atol=1e-5)


def test_perceptual_loss_matches_the_port():
    from tactile_gan_torch.losses.perceptual import vgg_perceptual_loss

    params = vgg_weights(5, "cpu")
    g = torch.Generator().manual_seed(2)
    a = torch.rand((2, 64, 64, 3), generator=g)
    b = torch.rand((2, 64, 64, 3), generator=g) * 2 - 1
    w = (0.0, 0.1, 0.3, 0.6)
    got = vgg_perceptual_loss(params, a, b, weights=w)
    want = vgg_perceptual(params, a.permute(0, 3, 1, 2),
                          b.permute(0, 3, 1, 2), w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_batches_match_the_port(tmp_path):
    from tactile_gan_torch.data.dataset import PairedDataset

    write_dataset(str(tmp_path), n_train=8, n_test=0, size=64, seed=9)
    img_dir = str(tmp_path / "train" / "source")
    seed, epoch, batch = 2 ** 31 + 77, 1, 2
    port = PairedDataset(img_dir, size=64, mode="train", aug=True).batches(
        batch, shuffle=True, seed=seed + epoch, drop_last=True, threads=2,
        host_augment=True, augment_seed=seed + 7919 * epoch)
    want = epoch_batches(img_dir, batch, seed, epoch, 4)
    for (src, tgt, _), (rs, rt) in zip(port, want):
        np.testing.assert_array_equal(src, rs)
        np.testing.assert_array_equal(tgt, rt)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_run_is_correct(workload, tiny_cell):
    cell = tiny_cell(workload)
    result, lines = run(ROOT, cell, 2 ** 31 + 11, 0.5, False, "cpu", 0.0)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0


# Read off the parent of the change that moved the networks into
# ``reference/networks/``: the reference step's FLOPs at each cell's
# shapes, the generator's norm shapes at batch 4 (count, elements, sha256
# of the list) and a sha256 of the weights made from seed 1 on the CPU.
PINNED_FLOPS = {"train.unetpp.b4": 4264635979776,
                "train.unet.b4": 1334352599040,
                "train.unetpp.b4v2": 4018684219392}
PINNED_NORMS = {
    "train.unetpp.b4": (30, 270532608, "8b3ce59ee545f6c368cd5e3fad57e7a4"
                        "aa327f1053d73649c26da4d52a509c4c"),
    "train.unet.b4": (28, 65683456, "31dcd5c08ea3b86855a810dac8d52006"
                      "f40e3c21ad12c45917ef16cd3bea76c0")}
PINNED_WEIGHTS = {
    ("train.unetpp.b4", "gen"): "ce56768e433e8af427966b269397fa8c"
                                "4075e29a05988c64a963cc1460a7b832",
    ("train.unet.b4", "gen"): "23631faeffd50327dac247ff2c466bb7"
                              "32834d46be2d9b191145cbb456f06954",
    ("train.unetpp.b4", "disc"): "5b24a5e04cc7ce2b9efdd366db7edf58"
                                 "3933c9099e3fe0ccc109dd9bc304891a"}


@pytest.mark.parametrize("workload", sorted(PINNED_FLOPS))
def test_step_flops_pinned(workload):
    cell = load_cell(ROOT, workload)
    assert step_flops(cell.config, cell.traffic) == PINNED_FLOPS[workload]


@pytest.mark.parametrize("workload", sorted(PINNED_NORMS))
def test_norm_shapes_pinned(workload):
    shapes = generator_norm_shapes(load_cell(ROOT, workload).config, 4)
    digest = hashlib.sha256(json.dumps([list(s) for s in shapes]).encode())
    assert (len(shapes), sum(math.prod(s) for s in shapes),
            digest.hexdigest()) == PINNED_NORMS[workload]


@pytest.mark.parametrize("workload,role", sorted(PINNED_WEIGHTS))
def test_weights_pinned(workload, role):
    config = load_cell(ROOT, workload).config
    net = networks(config, "f32", "meta")[("gen", "disc").index(role)]
    weights = network_weights(net, 1, role, "cpu")
    h = hashlib.sha256()
    for name in sorted(weights):
        h.update(name.encode())
        h.update(weights[name].contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED_WEIGHTS[(workload, role)]


_LAYERS = {
    "transposed_k3s2p1_op1": lambda: nn.ConvTranspose2d(
        6, 4, 3, stride=2, padding=1, output_padding=1),
    "transposed_groups_dilation": lambda: nn.ConvTranspose2d(
        6, 4, 3, stride=2, padding=2, output_padding=1, groups=2,
        dilation=2, bias=False),
    "dilated_grouped": lambda: nn.Conv2d(6, 4, 3, padding=2, dilation=2,
                                         groups=2),
}


@pytest.mark.parametrize("layer", sorted(_LAYERS))
def test_conv_matches_torch(layer):
    torch.manual_seed(0)
    m = _LAYERS[layer]()
    x = torch.randn(2, 6, 9, 11)
    with torch.no_grad():
        want = m(x)
        torch.testing.assert_close(ref_models.conv(x, m), want, rtol=1e-6,
                                   atol=1e-6)
        for prec in ("bf16", "fp8", "fp8_bwd", "bf16_fwd"):
            assert ref_models.conv(x, m, prec).shape == want.shape


def test_conv_refuses_a_padding_mode():
    with pytest.raises(ValueError, match="reflect"):
        ref_models.conv(torch.randn(1, 2, 8, 8),
                        nn.Conv2d(2, 2, 3, padding=1, padding_mode="reflect"))


@pytest.mark.parametrize("affine,act,module", [
    (False, None, lambda: nn.Identity()),
    (True, "relu", lambda: nn.ReLU()),
    (False, "leaky_relu", lambda: nn.LeakyReLU(0.2)),
])
def test_norm_act_matches_torch(affine, act, module):
    torch.manual_seed(1)
    norm = nn.InstanceNorm2d(5, affine=affine)
    if affine:
        with torch.no_grad():
            norm.weight.normal_()
            norm.bias.normal_()
    x = torch.randn(3, 5, 7, 6) * 4 + 1
    recorder = ref_models.NormRecorder()
    got = ref_models.norm_act(x, norm, recorder, act)
    torch.testing.assert_close(got, module()(norm(x)), rtol=1e-5, atol=1e-6)
    assert recorder.shapes == [(3, 5, 7, 6)]


def test_unknown_networks_name_the_table():
    config = load_cell(ROOT, "train.unetpp.b4").config
    for role, name in (("gen", "NoSuchNet"), ("disc", "NoSuchNet"),
                       ("disc", "UNet++")):
        with pytest.raises(KeyError) as err:
            networks(dict(config, **{role: name}), "f32", "meta")
        have = [n for n, e in table().items() if e.role == role]
        assert have and all(repr(n) in str(err.value) for n in have)
    with pytest.raises(KeyError, match="nf"):
        networks({k: v for k, v in config.items() if k != "nf"}, "f32",
                 "meta")


def test_the_port_trains_only_the_discriminators_it_builds(tiny_cell):
    from benchmark.core.cell import train_config

    cell = tiny_cell("train.unetpp.b4")
    cell.config["disc"] = "PatchGAN-wide"
    with pytest.raises(ValueError, match="disc"):
        train_config(cell, 1, "unused", "cpu")


_MODULE = 'NAME = {name!r}\nROLE = {role!r}\n{extra}NETWORK = object\n'


@pytest.mark.parametrize("files,error", [
    ({"a.py": _MODULE.format(name="A", role="gen", extra=""),
      }, "CPU_TEST_SIZE"),
    ({"a.py": "NAME = 'A'\nNETWORK = object\n"}, "ROLE"),
    ({"a.py": _MODULE.format(name="A", role="critic", extra="")}, "critic"),
    ({"a.py": _MODULE.format(name="A", role="disc", extra=""),
      "b.py": _MODULE.format(name="A", role="disc", extra="")}, "'A'"),
])
def test_the_table_refuses_a_module(tmp_path, files, error):
    for fname, text in files.items():
        (tmp_path / fname).write_text(text)
    (tmp_path / "_helpers.py").write_text("raise ImportError\n")
    with pytest.raises(ValueError, match=error):
        table(str(tmp_path))


class _Conv(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3)


class _Scaled(_Conv):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(4, 2))

    @staticmethod
    def published_init(name, shape, generator):
        return 1 + 0.02 * torch.randn(shape, generator=generator)


class _Uncovered(_Conv):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(4))


def test_published_init_draws_after_the_convs():
    plain = network_weights(_Conv(), 3, "gen", "cpu")
    first = network_weights(_Scaled(), 3, "gen", "cpu")
    again = network_weights(_Scaled(), 3, "gen", "cpu")
    for name, w in plain.items():
        assert torch.equal(first[name], w)
    assert first["scale"].shape == (4, 2)
    assert torch.equal(first["scale"], again["scale"])
    assert not torch.equal(first["scale"], torch.ones(4, 2))
    with pytest.raises(ValueError, match="scale"):
        network_weights(_Uncovered(), 3, "gen", "cpu")
