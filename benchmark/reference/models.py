"""The reference networks, in plain PyTorch on NCHW float32 tensors.

Written from the published generators of mmheydari97/tactile-gan
(``generators/UNet_plusplus.py``, ``generators/UNet.py``,
``discriminators/PatchGAN``) as the port trains them: UNet++ with a 5-row
backbone (widths nf..16nf, 2x2 average pooling, nearest upsampling, every
node two conv3x3 -> instance norm -> ReLU units, bias-free convs, affine
norms, a 1x1 head with Tanh); UNet with seven conv4x4/s2 down stages and
seven transposed-conv up stages; the conditional PatchGAN with valid
padding (LeakyReLU 0.2, passing x >= 0); the VGG16 feature tower up to
relu4_3. Parameter names are the port's ``state_dict`` keys, so one set
of weights loads into both.

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


def conv(x: torch.Tensor, layer: nn.Module, prec: str = "f32",
         transpose: bool = False) -> torch.Tensor:
    """``layer``'s conv (or transposed conv) on ``x`` under ``prec``; the
    bias is added in float32 after the rounded product."""
    fn = F.conv_transpose2d if transpose else F.conv2d
    if prec in _SPLIT:
        with torch.no_grad():
            value = _out(fn(_in(x, "bf16"), _in(layer.weight, "bf16"), None,
                            layer.stride, layer.padding), "bf16")
        back = _SPLIT[prec]
        y = _out(fn(_in(x, back), _in(layer.weight, back), None,
                    layer.stride, layer.padding), back)
        y = value + (y - y.detach())  # bf16's value, the backward's gradient
    else:
        y = _out(fn(_in(x, prec), _in(layer.weight, prec), None,
                    layer.stride, layer.padding), prec)
    if layer.bias is not None:
        y = y + layer.bias[None, :, None, None]
    return y


def instance_norm(x: torch.Tensor, norm: nn.InstanceNorm2d) -> torch.Tensor:
    """Biased variance over (H, W), eps 1e-5, affine."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + 1e-5)
    return y * norm.weight[None, :, None, None] + norm.bias[None, :, None, None]


class NormRecorder:
    """Collects the (N, C, H, W) shape of every generator instance norm a
    forward runs (the norm roofline's byte count reads it)."""

    def __init__(self):
        self.shapes: List[Tuple[int, ...]] = []


def _norm_relu(x, norm, recorder: Optional[NormRecorder]):
    if recorder is not None:
        recorder.shapes.append(tuple(x.shape))
    return torch.relu(instance_norm(x, norm))


def _double(in_ch: int, features: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(in_ch, features, 3, padding=1, bias=False),
        nn.InstanceNorm2d(features, affine=True), nn.ReLU(),
        nn.Conv2d(features, features, 3, padding=1, bias=False),
        nn.InstanceNorm2d(features, affine=True), nn.ReLU())


class _Block(nn.Module):
    def __init__(self, layer: nn.Sequential):
        super().__init__()
        self.layer = layer


class _Head(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1)


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
                                _Block(_double(cin, widths[row])))
        self.downfeature = _Head(nf, output_dim)

    def _node(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name).layer
        for ci, ni in ((0, 1), (3, 4)):
            x = _norm_relu(conv(x, layer[ci], self.prec), layer[ni],
                           self.recorder)
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


class UNet(nn.Module):
    STAGES = 7

    def __init__(self, input_dim: int = 3, output_dim: int = 3,
                 nf: int = 64, prec: str = "f32"):
        super().__init__()
        self.prec = prec
        self.recorder: Optional[NormRecorder] = None
        enc = [nf, nf * 2, nf * 4, nf * 8, nf * 8, nf * 8, nf * 8]
        for i, (cin, w) in enumerate(zip([input_dim] + enc[:-1], enc), 1):
            self.add_module(f"conv{i}", _Block(nn.Sequential(
                nn.Conv2d(cin, w, 4, stride=2, padding=1, bias=False),
                nn.InstanceNorm2d(w, affine=True), nn.ReLU(),
                nn.Conv2d(w, w, 3, padding=1, bias=False),
                nn.InstanceNorm2d(w, affine=True), nn.ReLU())))
        dec = [nf * 8, nf * 8, nf * 8, nf * 4, nf * 2, nf, nf]
        cins = [enc[-1]] + [d + e for d, e in zip(dec[:-1],
                                                  reversed(enc[:-1]))]
        for i, (cin, w) in enumerate(zip(cins, dec), 2):
            self.add_module(f"deconv{i}", _Block(nn.Sequential(
                nn.ConvTranspose2d(cin, w, 4, stride=2, padding=1,
                                   bias=False),
                nn.InstanceNorm2d(w, affine=True), nn.ReLU(),
                nn.Conv2d(w, w, 3, padding=1, bias=False),
                nn.InstanceNorm2d(w, affine=True), nn.ReLU())))
        self.downfeature = _Head(nf, output_dim)

    def _stage(self, name: str, x: torch.Tensor, up: bool) -> torch.Tensor:
        layer = getattr(self, name).layer
        x = _norm_relu(conv(x, layer[0], self.prec, transpose=up), layer[1],
                       self.recorder)
        return _norm_relu(conv(x, layer[3], self.prec), layer[4],
                          self.recorder)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(1, self.STAGES + 1):
            x = self._stage(f"conv{i}", x, up=False)
            skips.append(x)
        x = self._stage("deconv2", skips[-1], up=True)
        for i, skip in zip(range(3, self.STAGES + 2), reversed(skips[:-1])):
            x = self._stage(f"deconv{i}", torch.cat([x, skip], dim=1),
                            up=True)
        return torch.tanh(conv(x, self.downfeature.conv, self.prec))


GENERATORS = {"UNet++": UNetPlusPlus, "UNet": UNet}


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * 0.2)


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
            x = leaky_relu(instance_norm(conv(x, self.model[ci], self.prec),
                                         self.model[ci + 1]))
            features.append(x)
        return (torch.sigmoid(conv(x, self.model[11], self.prec)),
                tuple(features))


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
