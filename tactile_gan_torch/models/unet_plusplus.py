"""UNet++ generator (the default --gen UNet++).

Follows ``tactile_gan_tpu/models/unet_plusplus.py`` without its TPU layout
variants: a 5-row backbone of widths nf..16nf downsampled by 2x2 average
pooling, a dense grid of nested nodes, and a 1x1 head with optional Tanh.
Node (row, col) convolves the channel concatenation of every earlier node
on its row and the nearest-upsampled node (row+1, col-1). The
full-resolution row's 3x3 convs run kernel B, every norm kernel A.

Input and output are NHWC float32, like the JAX module. Module names are the
PyTorch reference's (``conv{r}_{c}.layer.{0,1,3,4}``, ``downfeature.conv``),
so ``tactile_gan_tpu/utils/torch_migrate.py`` reads this model's
``state_dict`` unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from tactile_gan_torch.models.blocks import DoubleConvBlock, Head
from tactile_gan_torch.ops.pool import avg_pool2
from tactile_gan_torch.ops.resize import upsample_nearest2

ROWS = 5


class UNetPlusPlus(nn.Module):

    def __init__(self, input_dim: int = 3, output_dim: int = 3, nf: int = 64,
                 activation: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [nf * 2 ** r for r in range(ROWS)]
        for row in range(ROWS):
            for col in range(ROWS - row):
                if col == 0:
                    cin = input_dim if row == 0 else widths[row - 1]
                else:
                    cin = widths[row] * col + widths[row + 1]
                self.add_module(f"conv{row}_{col}", DoubleConvBlock(
                    cin, widths[row], compute_dtype=compute_dtype,
                    full_res=row == 0, stem=(row, col) == (0, 0)))
        self.downfeature = Head(nf, output_dim, activation=activation,
                                compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, input_dim) float32 -> (N, H, W, output_dim) float32."""
        nodes = {}
        h = x
        for row in range(ROWS):
            if row > 0:
                h = avg_pool2(h)
            h = getattr(self, f"conv{row}_0")(h)
            nodes[(row, 0)] = h
        for col in range(1, ROWS):
            for row in range(ROWS - col):
                inputs = [nodes[(row, c)] for c in range(col)]
                inputs.append(upsample_nearest2(nodes[(row + 1, col - 1)]))
                nodes[(row, col)] = getattr(self, f"conv{row}_{col}")(
                    torch.cat(inputs, dim=-1))
        return self.downfeature(nodes[(0, ROWS - 1)])
