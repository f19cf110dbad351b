"""BCDUNet generator (``--gen BCDUNet``), the network its forward runs.

Follows ``tactile_gan_tpu/models/bcdunet.py``: the reference builds
ConvLSTM stacks and a dropout layer that its forward never calls, so, like
the JAX package, the port has only the live dataflow: a 4-level UNet with
2x2 max-pool downsampling, biased k2/s2 transposed-conv upsampling, skip
concatenations and a 1x1 head with optional Tanh. Its double convs have
biased convs and *non-affine* instance norms; each norm runs kernel A (C in
the backward) with no scale or offset, each conv the library's.

Module names are the PyTorch reference's (``conv{1..4}.{0,3}``,
``upconv{1..3}``, ``conv{1..3}m.{0,3}``, ``conv0``); ``upconv3`` is the
first up-conv applied. A reference ``state_dict`` also holds ``clstm*``
weights, which ``load_state_dict(strict=False)`` skips, as the reference's
own loaders do.
"""

from __future__ import annotations

import torch
from torch import nn

from tactile_gan_torch.models.blocks import double_conv, double_conv_layers
from tactile_gan_torch.ops.conv import conv_layer
from tactile_gan_torch.ops.pool import max_pool2

LEVELS = 4


class ConvBlock(nn.Sequential):
    """The reference's conv_block: its layers sit directly under the
    block's name (``conv1.0``, ``conv1.3``)."""

    def __init__(self, in_channels: int, features: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(*double_conv_layers(in_channels, features,
                                             use_bias=True,
                                             affine_norm=False))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return double_conv(x, self, compute_dtype=self.compute_dtype)


class BCDUNet(nn.Module):

    def __init__(self, input_dim: int = 3, output_dim: int = 3, nf: int = 64,
                 activation: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.compute_dtype = compute_dtype
        widths = [nf * 2 ** i for i in range(LEVELS)]
        for i, (cin, w) in enumerate(zip([input_dim] + widths[:-1], widths),
                                     start=1):
            self.add_module(f"conv{i}", ConvBlock(
                cin, w, compute_dtype=compute_dtype))
        for i in range(1, LEVELS):
            w = widths[i - 1]
            self.add_module(f"upconv{i}", nn.ConvTranspose2d(2 * w, w, 2,
                                                             stride=2))
            self.add_module(f"conv{i}m", ConvBlock(
                2 * w, w, compute_dtype=compute_dtype))
        self.conv0 = nn.Conv2d(nf, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, input_dim) float32, H and W multiples of 8 ->
        (N, H, W, output_dim) float32."""
        cd = self.compute_dtype
        skips = [self.conv1(x)]
        for i in range(2, LEVELS + 1):
            skips.append(getattr(self, f"conv{i}")(max_pool2(skips[-1])))
        d = skips.pop()
        for i in range(LEVELS - 1, 0, -1):
            up = getattr(self, f"upconv{i}")
            d = conv_layer(d, up, compute_dtype=cd)
            d = getattr(self, f"conv{i}m")(torch.cat([skips.pop(), d],
                                                     dim=-1))
        y = conv_layer(d, self.conv0, compute_dtype=cd)
        return torch.tanh(y) if self.activation else y
