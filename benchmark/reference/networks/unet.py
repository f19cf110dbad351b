"""UNet, written from mmheydari97/tactile-gan ``generators/UNet.py`` as
the port trains it: seven conv4x4/s2 down stages and seven transposed
conv4x4/s2 up stages, each followed by a conv3x3, every conv bias-free
and followed by an affine instance norm and ReLU, skips concatenated, a
1x1 head with Tanh. Parameter names are the port's ``state_dict`` keys."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from benchmark.reference.models import (
    Block, Head, NormRecorder, conv, norm_act,
)

NAME = "UNet"
ROLE = "gen"
CPU_TEST_SIZE = 256  # seven stride-2 stages: 2 px at the bottom


class UNet(nn.Module):
    STAGES = 7

    def __init__(self, input_dim: int = 3, output_dim: int = 3,
                 nf: int = 64, prec: str = "f32"):
        super().__init__()
        self.prec = prec
        self.recorder: Optional[NormRecorder] = None
        enc = [nf, nf * 2, nf * 4, nf * 8, nf * 8, nf * 8, nf * 8]
        for i, (cin, w) in enumerate(zip([input_dim] + enc[:-1], enc), 1):
            self.add_module(f"conv{i}", Block(nn.Sequential(
                nn.Conv2d(cin, w, 4, stride=2, padding=1, bias=False),
                nn.InstanceNorm2d(w, affine=True), nn.ReLU(),
                nn.Conv2d(w, w, 3, padding=1, bias=False),
                nn.InstanceNorm2d(w, affine=True), nn.ReLU())))
        dec = [nf * 8, nf * 8, nf * 8, nf * 4, nf * 2, nf, nf]
        cins = [enc[-1]] + [d + e for d, e in zip(dec[:-1],
                                                  reversed(enc[:-1]))]
        for i, (cin, w) in enumerate(zip(cins, dec), 2):
            self.add_module(f"deconv{i}", Block(nn.Sequential(
                nn.ConvTranspose2d(cin, w, 4, stride=2, padding=1,
                                   bias=False),
                nn.InstanceNorm2d(w, affine=True), nn.ReLU(),
                nn.Conv2d(w, w, 3, padding=1, bias=False),
                nn.InstanceNorm2d(w, affine=True), nn.ReLU())))
        self.downfeature = Head(nf, output_dim)

    def _stage(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name).layer
        x = norm_act(conv(x, layer[0], self.prec), layer[1], self.recorder,
                     "relu")
        return norm_act(conv(x, layer[3], self.prec), layer[4],
                        self.recorder, "relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(1, self.STAGES + 1):
            x = self._stage(f"conv{i}", x)
            skips.append(x)
        x = self._stage("deconv2", skips[-1])
        for i, skip in zip(range(3, self.STAGES + 2), reversed(skips[:-1])):
            x = self._stage(f"deconv{i}", torch.cat([x, skip], dim=1))
        return torch.tanh(conv(x, self.downfeature.conv, self.prec))


NETWORK = UNet
