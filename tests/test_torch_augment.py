"""The port's device augmentation (``data/augment.py``, ``--no-host_aug``)
against the JAX package's ``data/augment.py`` on the same uint8 batches and
the JAX keys' draws injected; one ``--no-host_aug`` training step against
the JAX step; the trainer's data path under the flag; and
``cli.visualize_augmentation``."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import visualize_augmentation as jax_visualize_cli
from tactile_gan_tpu.data.augment import (
    _inverse_affine_matrix as jax_inverse_affine_matrix,
    preprocess_batch as jax_preprocess_batch,
)

from test_torch_train import _write_train_pairs
from test_torch_variants import check_variant_step, jax_aug_draws

from tactile_gan_torch.cli import train as train_cli
from tactile_gan_torch.cli import visualize_augmentation as vis_cli
from tactile_gan_torch.data import augment
from tactile_gan_torch.data.dataset import PairedDataset

torch.set_num_threads(2)


def _jax_draw_values(k_aff):
    """The uniforms ``_inverse_affine_matrix`` draws from ``k_aff``."""
    k_t, k_s, k_r = jax.random.split(k_aff, 3)
    t = jax.random.uniform(k_t, (2,), minval=-0.1, maxval=0.1)
    s = jax.random.uniform(k_s, (2,), minval=0.8, maxval=1.2)
    r = jax.random.uniform(k_r, (), minval=-15.0, maxval=15.0)
    return np.asarray(t), np.asarray(s), np.asarray(r)


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_inverse_affine_matrix_matches_jax(h, w):
    keys = jax.random.split(jax.random.key(3), 16)
    want = np.stack([np.asarray(jax_inverse_affine_matrix(k, h, w))
                     for k in keys])
    t, s, r = (np.stack(v) for v in zip(*map(_jax_draw_values, keys)))
    got = augment.inverse_affine_matrix(torch.from_numpy(t),
                                        torch.from_numpy(s),
                                        torch.from_numpy(r), h, w)
    assert got.shape == (16, 2, 3) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=1e-6)
    # The offset is c - A (t + c), a difference of terms of the image's
    # size that may cancel to near 0 (and XLA's sin and cos differ from
    # torch's in the last bit): rel 1e-6 of those terms.
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    terms = np.abs(want[..., :2]) @ np.abs(t * [w, h] + c)[..., None]
    np.testing.assert_array_less(np.abs(got[..., 2] - want[..., 2]),
                                 1e-6 * (terms[..., 0] + np.abs(c)))


def _charts(n, size, seed):
    """uint8 sources (strokes on noise) and masks with sharp edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 255, (n, size, size, 3), np.uint8)
    tgt = np.zeros((n, size, size, 3), np.uint8)
    for i in range(n):
        for _ in range(6):
            y, x = rng.integers(0, size - 8, 2)
            tgt[i, y:y + int(rng.integers(2, 8)),
                x:x + int(rng.integers(2, 20))] = rng.integers(1, 255, 3)
    return src, tgt


def _mask_off(a, b):
    """The share of mask values that came from another source pixel: off by
    more than half a uint8 step (a float32 rounding is far below)."""
    return float((np.abs(a - b) > 0.5 / 255.0).mean())


def test_preprocess_batch_matches_jax():
    """Both flags' four combinations occur; the source within 1e-4 on the
    [0, 1] scale, at most 0.1% of the mask's pixels off (a coordinate a
    rounding away from .5 picks the other neighbour)."""
    n, size = 16, 64
    src, tgt = _charts(n, size, 5)
    key = jax.random.key(11)
    want_s, want_t = (np.asarray(v) for v in jax_preprocess_batch(
        jnp.asarray(src), jnp.asarray(tgt), key, augment=True))
    # preprocess_batch's own keys: split(key, n), then split(k, 3) each.
    draws = jax_aug_draws(None, n, size, size, k_aug=key)
    combos = set(zip(draws.flip.tolist(), draws.affine.tolist()))
    assert combos == {(a, b) for a in (False, True) for b in (False, True)}
    got_s, got_t = augment.preprocess_batch(
        torch.from_numpy(src), torch.from_numpy(tgt), augment=True,
        draws=draws)
    assert got_s.dtype == got_t.dtype == torch.float32
    assert np.abs((got_s.numpy() - want_s) / 2.0).max() <= 1e-4
    assert _mask_off(got_t.numpy(), want_t) <= 1e-3
    # The warp changed something, and the border fill is zero.
    assert np.abs(want_t - tgt / 255.0).max() > 0.5
    plain = augment.preprocess_batch(torch.from_numpy(src),
                                     torch.from_numpy(tgt), augment=False)
    want_plain = jax_preprocess_batch(jnp.asarray(src), jnp.asarray(tgt),
                                      key, augment=False)
    for a, b in zip(plain, want_plain):  # XLA may divide by 255 as x * (1/255)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_nearest_mask_is_not_sampled_bilinearly():
    """The check above catches a mask sampled bilinearly (the planted fault
    of chip_smoke.py's variants phase)."""
    n, size = 8, 64
    src, tgt = _charts(n, size, 6)
    key = jax.random.key(12)
    _, want_t = jax_preprocess_batch(jnp.asarray(src), jnp.asarray(tgt), key,
                                     augment=True)
    draws = jax_aug_draws(None, n, size, size, k_aug=key)
    t = torch.from_numpy(tgt).float() / 255.0
    flipped = torch.where(draws.flip[:, None, None, None],
                          torch.flip(t, dims=(2,)), t)
    wrong = torch.where(draws.affine[:, None, None, None],
                        augment.warp(flipped, draws.matrix, nearest=False),
                        flipped)
    assert _mask_off(wrong.numpy(), np.asarray(want_t)) > 1e-2


def test_draws_come_from_the_generator():
    """Seven uniforms a sample, turned into flags and the matrix; the same
    seed gives the same draws, and the ranges are albumentations'."""
    def draw(seed):
        return augment.draw_augment(256, 32, 48,
                                    torch.Generator().manual_seed(seed),
                                    "cpu")

    a, b, c = draw(1), draw(1), draw(2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.matrix, c.matrix)
    u = torch.rand((256, 7), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.flip, u[:, 0] < 0.5)
    assert torch.equal(a.affine, u[:, 1] < 0.5)
    assert 0.3 < a.flip.float().mean() < 0.7
    # The linear part is (S^-1 R^-1): its determinant is 1 / (sx sy).
    det = torch.linalg.det(a.matrix[:, :, :2].double())
    assert bool(((det > 1 / 1.44 - 1e-6) & (det < 1 / 0.64 + 1e-6)).all())


def test_no_host_aug_step_matches_jax():
    check_variant_step("no_host_aug")


def test_trainer_gives_the_dataset_no_host_augmentation(tmp_path,
                                                        monkeypatch):
    """--no-host_aug: the decode pool yields batches as decoded, and the
    step augments them; by default the host augments and the step does
    not."""
    root = str(tmp_path)
    _write_train_pairs(os.path.join(root, "data"), n=2, size=32, seed=4)
    seen = []
    real = PairedDataset.batches

    def spy(self, *a, **kw):
        seen.append(kw["host_augment"])
        return real(self, *a, **kw)

    monkeypatch.setattr(PairedDataset, "batches", spy)
    steps = []
    for extra in ((), ("--no-host_aug",)):
        trainer = train_cli.main([
            "--data", os.path.join(root, "data"), "--nf", "4",
            "--batch_size", "2", "--image_size", "32", "--total_epochs",
            "1", "--lambda_per", "0", "--compute_dtype", "float32",
            "--threads", "1", "--device", "cpu", *extra])
        steps.append(trainer.step_fn.augment)
    assert seen == [True, False] and steps == [False, True]


def test_visualize_helpers_equal_the_jax_clis():
    rng = np.random.default_rng(7)
    axes, grid, content = (rng.integers(0, 255, (9, 11), np.uint8)
                           for _ in range(3))
    np.testing.assert_array_equal(
        np.asarray(vis_cli.combine_channels(axes, grid, content)),
        np.asarray(jax_visualize_cli.combine_channels(axes, grid, content)))


@pytest.mark.parametrize("target_mode", ["rgb", "non_rgb"])
def test_visualize_augmentation_cli(tmp_path, target_mode, capsys):
    root = str(tmp_path)
    src_dir = os.path.join(root, "train", "source")
    tac_dir = os.path.join(root, "train", "tactile")
    os.makedirs(src_dir)
    os.makedirs(tac_dir)
    rng = np.random.default_rng(8)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)).save(
            os.path.join(src_dir, f"s_{i}.png"))
        if target_mode == "rgb":
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)
                            ).save(os.path.join(tac_dir, f"t_{i}.tiff"))
        else:
            for comp in ("axes", "grids", "content"):
                Image.fromarray(rng.integers(0, 255, (32, 32), np.uint8)
                                ).save(os.path.join(tac_dir,
                                                    f"t_{i}_{comp}.tiff"))
    out = os.path.join(root, "vis")
    vis_cli.main(["--data_dir", src_dir, "--output_dir", out,
                  "--num_samples", "2", "--target_mode", target_mode,
                  "--device", "cpu"])
    assert "wrote 2 raw/augmented sample pairs" in capsys.readouterr().out
    names = sorted(os.listdir(out))
    assert names == sorted(f"sample_{i}_{k}_{v}.png" for i in range(2)
                           for k in ("source", "target")
                           for v in ("raw", "aug"))
    raw = np.asarray(Image.open(os.path.join(out, "sample_0_source_raw.png")))
    first = np.asarray(Image.open(os.path.join(src_dir, "s_0.png")))
    # The [-1, 1] writer truncates: raw pixels come back within one step.
    assert raw.shape == (32, 32, 3)
    assert np.abs(raw.astype(int) - first.astype(int)).max() <= 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            vis_cli.main(["--data_dir", src_dir, "--output_dir", out])
