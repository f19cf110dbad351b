"""L1 and the version-1 VGG perceptual loss (``tactile_gan_tpu/losses/
perceptual.py``): both images ImageNet-normalized (the [-1, 1] and [0, 1]
images go through the normalization as they are, as the reference does),
bilinearly resized to 224x224, and compared block-wise with L1 under
``weights``. The version-2 ``pan_loss`` is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from tactile_gan_torch.models.vgg import vgg_features_apply
from tactile_gan_torch.ops.resize import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a.float() - b.float()))


def vgg_perceptual_loss(vgg_params: Dict[str, torch.Tensor],
                        input_img: torch.Tensor, target_img: torch.Tensor,
                        weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
                        resize: bool = True) -> torch.Tensor:
    """NHWC images -> sum_i weights[i] * L1(vgg_i(input), vgg_i(target))."""
    def prep(img):
        img = img.float()
        if img.shape[-1] != 3:
            img = img.repeat_interleave(3, dim=-1)
        mean = img.new_tensor(IMAGENET_MEAN)
        std = img.new_tensor(IMAGENET_STD)
        img = (img - mean) / std
        return resize_bilinear(img, (224, 224)) if resize else img

    x_feats = vgg_features_apply(vgg_params, prep(input_img))
    y_feats = vgg_features_apply(vgg_params, prep(target_img))
    loss = torch.zeros((), device=input_img.device)
    for w, x, y in zip(weights, x_feats, y_feats):
        loss = loss + l1_loss(x, y) * w
    return loss
