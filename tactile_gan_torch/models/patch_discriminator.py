"""Conditional PatchGAN discriminator (``tactile_gan_tpu/models/
patch_discriminator.py``, the default valid-padding network).

The source and the (real or generated) tactile image are concatenated on
channels and pushed through four 3x3 valid-padding conv blocks (6 -> nf s2
biased and un-normalized, nf -> 2nf s2, 2nf -> 4nf s1, 4nf -> 8nf s1; each
but the first instance-normalized, every one LeakyReLU(0.2)) and a 3x3
valid conv to one logit channel, with an optional sigmoid. A 256^2 input
gives a 57^2 patch map.

The gradient penalty differentiates D twice, so D runs on autograd-native
ops only: the library conv (``ops/conv.py``) and the plain instance norm
(``ops/norm.py``), never the first-order kernels. Module names are the
PyTorch reference's (``model.0``, ``model.2``, ``model.3``, ...,
``model.11``), so ``tactile_gan_tpu/utils/torch_migrate.py`` reads this
model's ``state_dict``. Activations are NHWC float32; the forward returns
(logits (N, H', W', 1) float32, the four post-LeakyReLU features).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from tactile_gan_torch.ops.conv import conv2d
from tactile_gan_torch.ops.norm import instance_norm

SLOPE = 0.2


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) with jax.nn.leaky_relu's choice at 0 (x >= 0 passes)."""
    return torch.where(x >= 0, x, x * SLOPE)


class PatchDiscriminator(nn.Module):

    def __init__(self, input_dim: int = 3, output_dim: int = 3, nf: int = 64,
                 activation: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.compute_dtype = compute_dtype
        cin = input_dim + output_dim
        self.model = nn.Sequential(
            nn.Conv2d(cin, nf, 3, stride=2, bias=True),          # 0
            nn.LeakyReLU(SLOPE),                                  # 1
            nn.Conv2d(nf, 2 * nf, 3, stride=2, bias=False),       # 2
            nn.InstanceNorm2d(2 * nf, affine=True),               # 3
            nn.LeakyReLU(SLOPE),                                  # 4
            nn.Conv2d(2 * nf, 4 * nf, 3, stride=1, bias=False),   # 5
            nn.InstanceNorm2d(4 * nf, affine=True),               # 6
            nn.LeakyReLU(SLOPE),                                  # 7
            nn.Conv2d(4 * nf, 8 * nf, 3, stride=1, bias=False),   # 8
            nn.InstanceNorm2d(8 * nf, affine=True),               # 9
            nn.LeakyReLU(SLOPE),                                  # 10
            nn.Conv2d(8 * nf, 1, 3, stride=1, bias=True),         # 11
        )

    def _conv(self, x: torch.Tensor, i: int) -> torch.Tensor:
        conv = self.model[i]
        return conv2d(x, conv.weight, stride=conv.stride[0], padding=0,
                      bias=conv.bias, compute_dtype=self.compute_dtype)

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        x = torch.cat([img_a, img_b], dim=-1)
        features = []
        x = leaky_relu(self._conv(x, 0))
        features.append(x)
        for conv_i in (2, 5, 8):
            norm = self.model[conv_i + 1]
            x = leaky_relu(instance_norm(self._conv(x, conv_i), norm.weight,
                                         norm.bias))
            features.append(x)
        logits = self._conv(x, 11).float()
        if self.activation:
            logits = torch.sigmoid(logits)
        return logits, tuple(features)
