"""Frozen VGG16 feature tower for the version-1 perceptual loss
(``tactile_gan_tpu/models/vgg.py``): the activations after relu1_2,
relu2_2, relu3_3 and relu4_3.

Pretrained weights come from a local ``.npz`` (``--vgg_weights`` or
``$TACTILE_GAN_VGG_WEIGHTS``) with torchvision's key names
``features.{idx}.weight`` (OIHW) and ``features.{idx}.bias``, the JAX
package's format. Without one the tower falls back to random He-normal
weights with zero biases, drawn from a seeded ``torch.Generator``: the JAX
package draws its fallback with ``jax.random``, which torch cannot
reproduce, so the two fallbacks are different towers (tests hand the JAX
tower to the port). The trainer prints the fallback banner and records
``vgg_random_fallback: true`` in params.txt.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np
import torch

from tactile_gan_torch.ops.conv import conv2d
from tactile_gan_torch.ops.pool import max_pool2

# (torchvision feature index, out_channels) per block; "M" is the 2x2 max
# pool that precedes the block.
BLOCKS = (
    ((0, 64), (2, 64)),                                   # relu1_2
    (("M", None), (5, 128), (7, 128)),                    # relu2_2
    (("M", None), (10, 256), (12, 256), (14, 256)),       # relu3_3
    (("M", None), (17, 512), (19, 512), (21, 512)),       # relu4_3
)
ENV_WEIGHTS = "TACTILE_GAN_VGG_WEIGHTS"
FALLBACK_SEED = 16


def resolve_weights_path(weights_path: str = "") -> str:
    """The .npz path load_vgg_features would use; '' if none exists."""
    path = weights_path or os.environ.get(ENV_WEIGHTS, "")
    return path if path and os.path.exists(path) else ""


def fallback_banner() -> str:
    return (
        "=" * 72 + "\n"
        "!! PERCEPTUAL LOSS V1 IS USING DETERMINISTIC *RANDOM* VGG FEATURES !!\n"
        "No pretrained VGG16 weights were found, so this run optimizes a\n"
        "different perceptual objective than ImageNet-pretrained VGG16.\n"
        f"Supply weights via --vgg_weights or ${ENV_WEIGHTS} (see\n"
        "scripts/export_vgg_weights.py), or silence this by training with\n"
        "--lambda_per 0. params.txt will record vgg_random_fallback=true.\n"
        + "=" * 72)


def _conv_layers():
    cin = 3
    for block in BLOCKS:
        for idx, cout in block:
            if idx != "M":
                yield idx, cin, cout
                cin = cout


def load_vgg_features(weights_path: str = "", device="cpu"
                      ) -> Dict[str, torch.Tensor]:
    """{'features.<idx>.weight': OIHW, 'features.<idx>.bias': (C,)} float32
    on ``device``: the npz's weights, or the seeded random fallback."""
    path = resolve_weights_path(weights_path)
    params = {}
    if path:
        raw = np.load(path)
        for idx, _, _ in _conv_layers():
            for kind in ("weight", "bias"):
                params[f"features.{idx}.{kind}"] = torch.from_numpy(
                    np.asarray(raw[f"features.{idx}.{kind}"], np.float32))
    else:
        gen = torch.Generator().manual_seed(FALLBACK_SEED)
        for idx, cin, cout in _conv_layers():
            std = math.sqrt(2.0 / (9 * cin))
            params[f"features.{idx}.weight"] = torch.randn(
                (cout, cin, 3, 3), generator=gen) * std
            params[f"features.{idx}.bias"] = torch.zeros(cout)
    return {k: v.to(device) for k, v in params.items()}


def vgg_features_apply(params: Dict[str, torch.Tensor], x: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """x: NHWC float32, already ImageNet-normalized. Returns the four block
    outputs (float32 convs, as the JAX tower runs them)."""
    outs = []
    for block in BLOCKS:
        for idx, _ in block:
            if idx == "M":
                x = max_pool2(x)
            else:
                x = torch.relu(conv2d(x, params[f"features.{idx}.weight"],
                                      padding=1,
                                      bias=params[f"features.{idx}.bias"]))
        outs.append(x)
    return tuple(outs)
