"""UNet++, written from mmheydari97/tactile-gan
``generators/UNet_plusplus.py`` as the port trains it: a 5-row backbone
(widths nf..16nf, 2x2 average pooling, nearest upsampling), every node
two conv3x3 -> instance norm -> ReLU units, bias-free convs, affine
norms, a 1x1 head with Tanh. Parameter names are the port's
``state_dict`` keys, so one set of weights loads into both."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models import (
    Block, Head, NormRecorder, conv, norm_act,
)

NAME = "UNet++"
ROLE = "gen"
CPU_TEST_SIZE = 64  # 16 px at row 4


def _double(in_ch: int, features: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(in_ch, features, 3, padding=1, bias=False),
        nn.InstanceNorm2d(features, affine=True), nn.ReLU(),
        nn.Conv2d(features, features, 3, padding=1, bias=False),
        nn.InstanceNorm2d(features, affine=True), nn.ReLU())


class UNetPlusPlus(nn.Module):
    ROWS = 5

    def __init__(self, input_dim: int = 3, output_dim: int = 3,
                 nf: int = 64, prec: str = "f32"):
        super().__init__()
        self.prec = prec
        self.recorder: Optional[NormRecorder] = None
        widths = [nf * 2 ** r for r in range(self.ROWS)]
        for row in range(self.ROWS):
            for col in range(self.ROWS - row):
                if (row, col) == (0, 0):
                    cin = input_dim
                elif col == 0:
                    cin = widths[row - 1]
                else:
                    cin = widths[row] * col + widths[row + 1]
                self.add_module(f"conv{row}_{col}",
                                Block(_double(cin, widths[row])))
        self.downfeature = Head(nf, output_dim)

    def _node(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name).layer
        for ci, ni in ((0, 1), (3, 4)):
            x = norm_act(conv(x, layer[ci], self.prec), layer[ni],
                         self.recorder, "relu")
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nodes = {}
        h = x
        for row in range(self.ROWS):
            if row > 0:
                h = F.avg_pool2d(h, 2)
            h = self._node(f"conv{row}_0", h)
            nodes[(row, 0)] = h
        for col in range(1, self.ROWS):
            for row in range(self.ROWS - col):
                inputs = [nodes[(row, c)] for c in range(col)]
                inputs.append(F.interpolate(nodes[(row + 1, col - 1)],
                                            scale_factor=2, mode="nearest"))
                nodes[(row, col)] = self._node(f"conv{row}_{col}",
                                               torch.cat(inputs, dim=1))
        return torch.tanh(conv(nodes[(0, self.ROWS - 1)],
                               self.downfeature.conv, self.prec))


NETWORK = UNetPlusPlus
