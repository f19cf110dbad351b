"""L1 and both perceptual losses of ``tactile_gan_tpu/losses/perceptual.py``.

- ``pan_loss`` (version 2): L1 or L2 over the discriminator's four feature
  maps, or over their channel grams, under weights normalized to sum 1.
  The training step detaches both feature sets, so the term is logged and
  trains nothing (the reference's detached hooks).
- ``vgg_perceptual_loss`` (version 1): both images ImageNet-normalized (the
  [-1, 1] and [0, 1] images go through the normalization as they are, as
  the reference does), bilinearly resized to 224x224, and compared
  block-wise with L1 under ``weights``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from tactile_gan_torch.models.vgg import vgg_features_apply
from tactile_gan_torch.ops.resize import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a.float() - b.float()))


def gram(feat: torch.Tensor) -> torch.Tensor:
    """Channel gram of NHWC features: (N, H, W, C) -> (N, C, C) float32."""
    n, h, w, c = feat.shape
    f = feat.reshape(n, h * w, c).float()
    return torch.bmm(f.transpose(1, 2), f)


def pan_loss(real_features: Sequence[torch.Tensor],
             fake_features: Sequence[torch.Tensor], mode: str = "normal",
             loss_type: str = "l1",
             weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """sum_i w_i * d(real_i, fake_i) over the four feature maps, ``d`` the
    mean absolute (l1) or squared (l2) difference of the maps ('normal') or
    of their grams ('gram'); ``w`` is ``weights`` over its float32 sum."""
    if mode not in ("normal", "gram"):
        raise ValueError("mode must be normal or gram")
    if loss_type not in ("l1", "l2"):
        raise ValueError("loss_type must be l1 or l2")
    if len(weights) != 4:
        raise ValueError("weights must be a list of 4 numbers")
    # As Python floats: a CUDA-graph capture refuses a host-to-device copy.
    w = np.asarray(weights, np.float32)
    w = (w / w.sum()).tolist()

    def elem(a, b):
        d = a.float() - b.float()
        return torch.mean(torch.abs(d)) if loss_type == "l1" else \
            torch.mean(d * d)

    total = torch.zeros((), device=real_features[0].device)
    for i in range(4):
        real, fake = real_features[i], fake_features[i]
        if mode == "gram":
            real, fake = gram(real), gram(fake)
        total = total + elem(real, fake) * w[i]
    return total


def vgg_perceptual_loss(vgg_params: Dict[str, torch.Tensor],
                        input_img: torch.Tensor, target_img: torch.Tensor,
                        weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
                        resize: bool = True) -> torch.Tensor:
    """NHWC images -> sum_i weights[i] * L1(vgg_i(input), vgg_i(target))."""
    def prep(img):
        img = img.float()
        if img.shape[-1] != 3:
            img = img.repeat_interleave(3, dim=-1)
        # Per channel with the constants as scalars: no host-to-device
        # copy, which a CUDA-graph capture refuses.
        img = torch.stack([(img[..., c] - m) / s for c, (m, s) in enumerate(
            zip(IMAGENET_MEAN, IMAGENET_STD))], dim=-1)
        return resize_bilinear(img, (224, 224)) if resize else img

    x_feats = vgg_features_apply(vgg_params, prep(input_img))
    y_feats = vgg_features_apply(vgg_params, prep(target_img))
    loss = torch.zeros((), device=input_img.device)
    for w, x, y in zip(weights, x_feats, y_feats):
        loss = loss + l1_loss(x, y) * w
    return loss
