"""UNet++ generator (the default --gen UNet++).

Follows ``tactile_gan_tpu/models/unet_plusplus.py`` without its TPU layout
variants: a 5-row backbone of widths nf..16nf downsampled by 2x2 average
pooling, a dense grid of nested nodes, and a 1x1 head with optional Tanh.
Node (row, col) convolves the channel concatenation of every earlier node
on its row and the nearest-upsampled node (row+1, col-1). The
full-resolution row's 3x3 convs run kernel B, every norm kernel A.

``space_to_depth=True`` is the JAX package's ``--space_to_depth`` variant
(another network, with its own checkpoints): row 0 runs 2x2-folded, H/2 x
W/2 x 2nf (read as H x W x nf/2), so the stem takes 4 * input_dim
channels; row 1 enters through the mean over the four folded channel
groups; the nested row-0 nodes concatenate the row-1 node without
upsampling (it is already aligned with the folded row); and the last
row-0 node unfolds to H x W x nf/2 before the head. Row 0's convs run
kernel B where their width 2nf is <= 64.

``bf16_resident=True`` is the JAX package's ``--bf16_resident``: under a
bf16 compute dtype every row, row 0 and the stem included, keeps bf16
activations between ops (conv outputs, norms, ReLUs, pooling, upsampling,
the concatenations and the s2d fold); only the head emits float32. Under
float32 compute it changes nothing.

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
from tactile_gan_torch.ops.resize import (
    depth_to_space2, space_to_depth2, upsample_nearest2,
)

ROWS = 5


class UNetPlusPlus(nn.Module):

    def __init__(self, input_dim: int = 3, output_dim: int = 3, nf: int = 64,
                 activation: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 space_to_depth: bool = False, bf16_resident: bool = False):
        super().__init__()
        if space_to_depth and nf % 2:
            raise ValueError("space_to_depth needs an even nf (the row-0 "
                             "width 2*nf must unfold by 4 at the head)")
        self.space_to_depth = space_to_depth
        self.bf16_resident = bf16_resident
        widths = [nf * 2 ** r for r in range(ROWS)]
        if space_to_depth:
            widths[0] = 2 * nf
        for row in range(ROWS):
            for col in range(ROWS - row):
                if (row, col) == (0, 0):
                    cin = 4 * input_dim if space_to_depth else input_dim
                elif (row, col) == (1, 0) and space_to_depth:
                    cin = widths[0] // 4
                elif col == 0:
                    cin = widths[row - 1]
                else:
                    cin = widths[row] * col + widths[row + 1]
                self.add_module(f"conv{row}_{col}", DoubleConvBlock(
                    cin, widths[row], compute_dtype=compute_dtype,
                    full_res=row == 0, stem=(row, col) == (0, 0),
                    resident=bf16_resident))
        self.downfeature = Head(widths[0] // 4 if space_to_depth else nf,
                                output_dim, activation=activation,
                                compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, input_dim) float32 -> (N, H, W, output_dim) float32."""
        s2d = self.space_to_depth
        nodes = {}
        h = space_to_depth2(x) if s2d else x
        for row in range(ROWS):
            if row == 1 and s2d:
                # The logical 2x2 average of the folded row: the mean over
                # its four channel groups.
                n, hh, ww, c = h.shape
                h = h.reshape(n, hh, ww, 4, c // 4).mean(dim=3)
            elif row > 0:
                h = avg_pool2(h)
            h = getattr(self, f"conv{row}_0")(h)
            nodes[(row, 0)] = h
        for col in range(1, ROWS):
            for row in range(ROWS - col):
                inputs = [nodes[(row, c)] for c in range(col)]
                below = nodes[(row + 1, col - 1)]
                inputs.append(below if row == 0 and s2d
                              else upsample_nearest2(below))
                nodes[(row, col)] = getattr(self, f"conv{row}_{col}")(
                    torch.cat(inputs, dim=-1))
        out = nodes[(0, ROWS - 1)]
        return self.downfeature(depth_to_space2(out) if s2d else out)
