"""Generator building blocks on NHWC activations.

Parameters live in ordinary ``nn.Conv2d`` / ``nn.ConvTranspose2d`` /
``nn.InstanceNorm2d`` modules so ``state_dict`` names and shapes are the
PyTorch reference's (``layer.{0,1,3,4}``, ``conv``); the forward runs the
port's own ops: ``ops/conv.py`` (library conv and transposed conv) for convs
that stay on the library, kernel B for UNet++'s full-resolution 3x3 convs,
and kernel A for every instance norm + ReLU, affine or not. The
full-resolution row's convs run kernel B where Co <= 64, which is where the
JAX package runs its packed Pallas conv (2 Co <= 128 lanes); a wider row
(nf > 64) takes the library conv, as the JAX package takes XLA's. UNet's
``DownBlock`` / ``UpBlock`` and BCDUNet's biased, non-affine double convs
run every conv on the library, as the JAX package runs them on XLA.
Initialization is the reference's: conv and transposed-conv weights
~ N(0, 0.02), biases zero, instance-norm affine (1, 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tactile_gan_torch.ops.conv import conv_layer
from tactile_gan_torch.ops.kernels import conv3x3 as kb
from tactile_gan_torch.ops.kernels.instance_norm import instance_norm_act


def conv_norm_relu(x: torch.Tensor, conv: nn.Conv2d, norm: nn.InstanceNorm2d,
                   *, compute_dtype: torch.dtype,
                   kernel_conv: bool) -> torch.Tensor:
    """conv -> instance norm -> ReLU, the unit every generator block repeats.

    ``kernel_conv`` runs the (3x3/s1/p1, bias-free) conv through kernel B.
    """
    y = conv_layer(x, conv, compute_dtype=compute_dtype, kernel=kernel_conv)
    return instance_norm_act(y, norm.weight, norm.bias, act="relu")


def double_conv_layers(in_channels: int, features: int, *,
                       use_bias: bool = False,
                       affine_norm: bool = True) -> Tuple[nn.Module, ...]:
    """(conv3x3, IN, ReLU) twice at constant width: UNet++'s ConvBlock
    (bias-free convs, affine norms) or, with ``use_bias=True,
    affine_norm=False``, BCDUNet's conv_block."""
    return (nn.Conv2d(in_channels, features, 3, padding=1, bias=use_bias),
            nn.InstanceNorm2d(features, affine=affine_norm),
            nn.ReLU(),
            nn.Conv2d(features, features, 3, padding=1, bias=use_bias),
            nn.InstanceNorm2d(features, affine=affine_norm),
            nn.ReLU())


def double_conv(x: torch.Tensor, layers: nn.Sequential, *,
                compute_dtype: torch.dtype,
                kernel_convs: Tuple[bool, bool] = (False, False)
                ) -> torch.Tensor:
    """The two units of ``double_conv_layers`` on NHWC ``x``."""
    for (conv, norm), kernel_conv in zip(
            ((layers[0], layers[1]), (layers[3], layers[4])), kernel_convs):
        x = conv_norm_relu(x, conv, norm, compute_dtype=compute_dtype,
                           kernel_conv=kernel_conv)
    return x


class DoubleConvBlock(nn.Module):
    """Two conv3x3 -> IN -> ReLU units: UNet++'s ConvBlock (bias-free convs,
    affine norms).

    ``full_res`` marks a block of the full-resolution row, whose convs run
    kernel B where ``features`` <= 64; the ``stem`` block's first conv (3
    input channels) stays on the library conv, as in the JAX package.
    """

    def __init__(self, in_channels: int, features: int, *,
                 compute_dtype: torch.dtype = torch.float32,
                 full_res: bool = False, stem: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        b = full_res and kb.supported(features)
        self.kernel_convs = (b and not stem, b)
        self.layer = nn.Sequential(*double_conv_layers(in_channels, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return double_conv(x, self.layer, compute_dtype=self.compute_dtype,
                           kernel_convs=self.kernel_convs)


class DownBlock(nn.Module):
    """UNet's encoder stage (the reference's ConvDown): conv4x4/s2/p1 -> IN
    -> ReLU, then conv3x3 -> IN -> ReLU; bias-free convs, affine norms."""

    def __init__(self, in_channels: int, features: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.layer = nn.Sequential(
            nn.Conv2d(in_channels, features, 4, stride=2, padding=1,
                      bias=False),
            nn.InstanceNorm2d(features, affine=True),
            nn.ReLU(),
            nn.Conv2d(features, features, 3, padding=1, bias=False),
            nn.InstanceNorm2d(features, affine=True),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return double_conv(x, self.layer, compute_dtype=self.compute_dtype)


class UpBlock(nn.Module):
    """UNet's decoder stage (the reference's DeconvUp): convT4x4/s2/p1 ->
    IN -> ReLU, then conv3x3 -> IN -> ReLU; bias-free convs, affine
    norms."""

    def __init__(self, in_channels: int, features: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.layer = nn.Sequential(
            nn.ConvTranspose2d(in_channels, features, 4, stride=2, padding=1,
                               bias=False),
            nn.InstanceNorm2d(features, affine=True),
            nn.ReLU(),
            nn.Conv2d(features, features, 3, padding=1, bias=False),
            nn.InstanceNorm2d(features, affine=True),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up, norm = self.layer[0], self.layer[1]
        y = conv_layer(x, up, compute_dtype=self.compute_dtype)
        y = instance_norm_act(y, norm.weight, norm.bias, act="relu")
        return conv_norm_relu(y, self.layer[3], self.layer[4],
                              compute_dtype=self.compute_dtype,
                              kernel_conv=False)


class Head(nn.Module):
    """1x1 projection with optional Tanh (the reference's FeatureMapBlock);
    the output is always float32."""

    def __init__(self, in_channels: int, features: int, *,
                 activation: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(in_channels, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_layer(x, self.conv, compute_dtype=self.compute_dtype)
        return torch.tanh(y) if self.activation else y


@torch.no_grad()
def init_weights(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Conv and transposed-conv weights ~ N(0, 0.02) and biases 0; norms
    keep (1, 0)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.InstanceNorm2d) and m.affine:
            m.weight.fill_(1.0)
            m.bias.zero_()
