"""What the reference networks share, in plain PyTorch on NCHW float32
tensors: each layer's conv under a precision, the instance norm and its
activation, the norm recorder, and the VGG16 feature tower of the v1
perceptual loss up to relu4_3. The networks themselves are one module
each under ``networks/``, found by the name a configuration gives
(``networks/__init__.py``); nothing here names one.

``prec`` rounds the operands of every conv of G and D (never of the VGG
tower), as a lower precision would: "f32" rounds nothing (the
reference), "bf16" rounds each conv's input, weight and output and, going
back, its output gradient and its input and weight gradients to bfloat16
(the arithmetic of the configuration's bf16 conv compute), "fp8" rounds
input and weight to float8 e4m3 and the output gradient to e5m2, each
with a per-tensor scale (the control: one precision below bf16);
"fp8_bwd" takes the forward's values in bf16 and the backward as "fp8"
does, from e4m3 operands and an e5m2 output gradient (the control of G's
backward alone); "bf16_fwd" the forward's values in bf16 and the backward
in float32 (a witness: what the forward's rounding alone does to the
gradients). Imports torch only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32; a float8 dtype is
    scaled per tensor so that the largest magnitude maps to its largest
    finite value."""
    if dtype in _FP8_MAX:
        scale = _FP8_MAX[dtype] / x.detach().abs().amax().clamp(min=1e-30)
        return (x * scale).to(dtype).float() / scale
    return x.to(dtype).float()


class _RoundValue(torch.autograd.Function):
    """Rounds in the forward; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, dtype):
        return quantize(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """Passes the value; rounds the gradient (differentiably, for the
    gradient penalty's second backward)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _RoundValue.apply(g, ctx.dtype), None


def _in(x: torch.Tensor, prec: str) -> torch.Tensor:
    """An operand of a conv under ``prec``."""
    if prec == "bf16":
        return _RoundValue.apply(_RoundGrad.apply(x, torch.bfloat16),
                                 torch.bfloat16)
    if prec == "fp8":
        return _RoundValue.apply(x, torch.float8_e4m3fn)
    return x


def _out(y: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "bf16":
        return _RoundValue.apply(_RoundGrad.apply(y, torch.bfloat16),
                                 torch.bfloat16)
    if prec == "fp8":
        return _RoundGrad.apply(y, torch.float8_e5m2)
    return y


# A precision whose forward values are bf16's -> its backward's precision.
_SPLIT = {"fp8_bwd": "fp8", "bf16_fwd": "f32"}


def _apply(x: torch.Tensor, weight: torch.Tensor, layer: nn.Module
           ) -> torch.Tensor:
    """``layer``'s product on ``x`` with ``weight`` in its place, at every
    part of the layer's geometry."""
    if isinstance(layer, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, weight, None, layer.stride,
                                  layer.padding, layer.output_padding,
                                  layer.groups, layer.dilation)
    return F.conv2d(x, weight, None, layer.stride, layer.padding,
                    layer.dilation, layer.groups)


def conv(x: torch.Tensor, layer: nn.Module, prec: str = "f32"
         ) -> torch.Tensor:
    """``layer``'s conv (or transposed conv) on ``x`` under ``prec``; the
    bias is added in float32 after the rounded product."""
    if layer.padding_mode != "zeros":
        raise ValueError(f"padding_mode {layer.padding_mode!r}: pad the "
                         "input in the network (F.pad) and give the layer "
                         "zero padding")
    if prec in _SPLIT:
        with torch.no_grad():
            value = _out(_apply(_in(x, "bf16"), _in(layer.weight, "bf16"),
                                layer), "bf16")
        back = _SPLIT[prec]
        y = _out(_apply(_in(x, back), _in(layer.weight, back), layer), back)
        y = value + (y - y.detach())  # bf16's value, the backward's gradient
    else:
        y = _out(_apply(_in(x, prec), _in(layer.weight, prec), layer), prec)
    if layer.bias is not None:
        y = y + layer.bias[None, :, None, None]
    return y


def instance_norm(x: torch.Tensor, norm: nn.InstanceNorm2d) -> torch.Tensor:
    """Biased variance over (H, W), the norm's eps; scaled and shifted
    where the norm is affine."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + norm.eps)
    if not norm.affine:
        return y
    return y * norm.weight[None, :, None, None] + norm.bias[None, :, None, None]


class NormRecorder:
    """Collects the (N, C, H, W) shape of every generator instance norm a
    forward runs (the norm roofline's byte count reads it)."""

    def __init__(self):
        self.shapes: List[Tuple[int, ...]] = []


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * 0.2)


ACTIVATIONS = {"relu": torch.relu, "leaky_relu": leaky_relu,
               None: lambda x: x}


def norm_act(x: torch.Tensor, norm: nn.InstanceNorm2d,
             recorder: Optional[NormRecorder], act: Optional[str]
             ) -> torch.Tensor:
    """``norm`` on ``x``, then ``act`` ("relu", "leaky_relu" (slope 0.2,
    passing x >= 0) or None); ``x``'s shape goes to ``recorder`` where one
    is given (a generator's norms)."""
    if recorder is not None:
        recorder.shapes.append(tuple(x.shape))
    return ACTIVATIONS[act](instance_norm(x, norm))


class Block(nn.Module):
    """Holds a stage's layers as ``layer`` (the port's module names)."""

    def __init__(self, layer: nn.Sequential):
        super().__init__()
        self.layer = layer


class Head(nn.Module):
    """The 1x1 output conv, as ``conv``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1)


# (torchvision feature index, out_channels) per block; "M" is the 2x2 max
# pool before the block.
VGG_BLOCKS = (
    ((0, 64), (2, 64)),
    (("M", None), (5, 128), (7, 128)),
    (("M", None), (10, 256), (12, 256), (14, 256)),
    (("M", None), (17, 512), (19, 512), (21, 512)),
)


def vgg_layers(input_dim: int = 3):
    """(feature index, cin, cout) of each VGG16 conv up to relu4_3."""
    cin = input_dim
    for block in VGG_BLOCKS:
        for idx, cout in block:
            if idx != "M":
                yield idx, cin, cout
                cin = cout


def vgg_features(params: Dict[str, torch.Tensor], x: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """NCHW float32 convs (the tower is float32 in the configuration)."""
    outs = []
    for block in VGG_BLOCKS:
        for idx, _ in block:
            if idx == "M":
                x = F.max_pool2d(x, 2)
            else:
                x = torch.relu(F.conv2d(x, params[f"features.{idx}.weight"],
                                        params[f"features.{idx}.bias"],
                                        padding=1))
        outs.append(x)
    return tuple(outs)
