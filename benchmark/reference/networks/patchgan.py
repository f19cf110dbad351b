"""The conditional PatchGAN, written from mmheydari97/tactile-gan
``discriminators/PatchGAN`` as the port trains it: five 3x3 convs with
valid padding (strides 2, 2, 1, 1, 1), the first and last biased, affine
instance norms on the middle three, LeakyReLU 0.2 (passing x >= 0) after
all but the last, a sigmoid on the patch map. Parameter names are the
port's ``state_dict`` keys."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.models import conv, leaky_relu, norm_act

NAME = "PatchGAN"
ROLE = "disc"


class PatchDiscriminator(nn.Module):
    """Returns (sigmoid patch logits (N, 1, H', W'), the four post-LeakyReLU
    feature maps)."""

    def __init__(self, input_dim: int = 3, output_dim: int = 3,
                 nf: int = 64, prec: str = "f32"):
        super().__init__()
        self.prec = prec
        cin = input_dim + output_dim
        self.model = nn.Sequential(
            nn.Conv2d(cin, nf, 3, 2, 0, bias=True), nn.LeakyReLU(0.2),
            nn.Conv2d(nf, 2 * nf, 3, 2, 0, bias=False),
            nn.InstanceNorm2d(2 * nf, affine=True), nn.LeakyReLU(0.2),
            nn.Conv2d(2 * nf, 4 * nf, 3, 1, 0, bias=False),
            nn.InstanceNorm2d(4 * nf, affine=True), nn.LeakyReLU(0.2),
            nn.Conv2d(4 * nf, 8 * nf, 3, 1, 0, bias=False),
            nn.InstanceNorm2d(8 * nf, affine=True), nn.LeakyReLU(0.2),
            nn.Conv2d(8 * nf, 1, 3, 1, 0, bias=True))

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor):
        x = torch.cat([img_a, img_b], dim=1)
        x = leaky_relu(conv(x, self.model[0], self.prec))
        features = [x]
        for ci in (2, 5, 8):
            x = norm_act(conv(x, self.model[ci], self.prec),
                         self.model[ci + 1], None, "leaky_relu")
            features.append(x)
        return (torch.sigmoid(conv(x, self.model[11], self.prec)),
                tuple(features))


NETWORK = PatchDiscriminator
