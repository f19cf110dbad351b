"""The reference against the port at a tiny size on the CPU: the networks'
forwards, the perceptual loss and the data layer agree, and each cell's
whole run, at float32 compute, comes out correct under its limits."""

import numpy as np
import pytest
import torch

from benchmark.core.runner import run
from benchmark.core.weights import load_into, network_weights, vgg_weights
from benchmark.reference import models as ref_models
from benchmark.reference.data import epoch_batches
from benchmark.reference.step import vgg_perceptual
from benchmark.tests.conftest import ROOT, WORKLOADS
from benchmark.traffic_gen.synth import write_dataset


def _pair(gen, nf, seed):
    from tactile_gan_torch.models.factory import (
        create_discriminator, create_generator,
    )
    port_g = create_generator(gen, nf=nf)
    port_d = create_discriminator(nf=nf)
    ref_g = ref_models.GENERATORS[gen](nf=nf)
    ref_d = ref_models.PatchDiscriminator(nf=nf)
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


@pytest.mark.parametrize("gen,size", [("UNet++", 64), ("UNet", 256)])
def test_forwards_match_the_port(gen, size):
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
