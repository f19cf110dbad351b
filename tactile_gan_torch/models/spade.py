"""SPADE's generator, GauGAN (``--gen SPADE``).

Park et al., "Semantic Image Synthesis with Spatially-Adaptive
Normalization" (CVPR 2019, arXiv:1903.07291), as NVlabs/SPADE builds it in
``models/networks/generator.py`` ``SPADEGenerator`` with ``--ngf 64
--num_upsampling_layers normal --norm_G spadeinstance3x3`` and no VAE: the
conditioning map ``seg`` is the generator's own input (here the chart's RGB
source), fed into every normalization at that layer's scale.

- ``SPADE(C)``: x_hat = IN(x), non-affine (kernel A with no activation, C
  in the backward); s = seg resized (nearest) to x's size; a =
  ReLU(conv3x3(s; -> 128)); gamma, beta = conv3x3(a; 128 -> C) each; out =
  x_hat * (1 + gamma) + beta. The modulation is plain PyTorch, captured
  into the step's graph with the rest.
- ``SPADEResnetBlock(fin, fout)``, fm = min(fin, fout): dx =
  conv3x3(lrelu(SPADE(fin)(x)); fin -> fm), dx = conv3x3(lrelu(SPADE(fm)
  (dx)); fm -> fout), out = x_s + dx, where x_s = conv1x1(SPADE(fin)(x);
  bias-free) if fin != fout, else x. LeakyReLU slope 0.2.
- The generator: fc = conv3x3(seg at H/32 x W/32; -> 16 nf); head_0 (16nf,
  16nf); up; G_middle_0, G_middle_1 (16nf, 16nf); then, each after an up,
  up_0 (16nf, 8nf), up_1 (8nf, 4nf), up_2 (4nf, 2nf), up_3 (2nf, nf);
  tanh(conv3x3(lrelu(x); nf -> output_dim)). "up" is the nearest 2x
  upsample. Eighteen SPADE layers a forward.

Every conv runs the library conv of ``ops/conv.py`` under the compute
dtype, with its bias. Each SPADE layer is bracketed by marker kernels on
the card, forward and backward (``utils/profiling.py`` ``layer_mark`` with
``LAYER``: ``tg_mark_spade_in``, ``_out``, ``_bwd_out`` and ``_bwd_in``),
and ``SPADE.calls`` counts the layers' forwards on any device.

Input and output are NHWC float32, H and W multiples of 32. Module and
parameter names are NVlabs/SPADE's (``head_0.norm_0.mlp_shared.0.weight``,
``up_3.conv_s.weight``, ``conv_img.bias``, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tactile_gan_torch.ops.conv import conv_layer
from tactile_gan_torch.ops.kernels.instance_norm import instance_norm_act
from tactile_gan_torch.ops.resize import downsample_nearest, upsample_nearest2
from tactile_gan_torch.utils.profiling import layer_mark

HIDDEN = 128      # SPADE's shared conv width (nhidden)
UPSAMPLINGS = 5   # "normal": the trunk starts at H/32 x W/32
SLOPE = 0.2       # the blocks' and the head's LeakyReLU
LAYER = "spade"   # the SPADE layers' marks, tg_mark_spade_*


class SPADE(nn.Module):
    """x_hat * (1 + gamma(seg)) + beta(seg) for a non-affine instance norm
    x_hat of x. ``calls`` counts forwards (18 a generator forward)."""

    calls = 0

    def __init__(self, norm_nc: int, label_nc: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.param_free_norm = nn.InstanceNorm2d(norm_nc, affine=False)
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, HIDDEN, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(HIDDEN, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(HIDDEN, norm_nc, 3, padding=1)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        SPADE.calls += 1
        cd = self.compute_dtype
        x = layer_mark(x, LAYER, "in")
        normalized = instance_norm_act(x, act=None)
        s = downsample_nearest(seg, seg.shape[1] // x.shape[1])
        a = torch.relu(conv_layer(s, self.mlp_shared[0], compute_dtype=cd))
        gamma = conv_layer(a, self.mlp_gamma, compute_dtype=cd)
        beta = conv_layer(a, self.mlp_beta, compute_dtype=cd)
        return layer_mark(normalized * (1 + gamma) + beta, LAYER, "out")


class SPADEResnetBlock(nn.Module):

    def __init__(self, fin: int, fout: int, label_nc: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.learned_shortcut = fin != fout
        fmiddle = min(fin, fout)
        self.conv_0 = nn.Conv2d(fin, fmiddle, 3, padding=1)
        self.conv_1 = nn.Conv2d(fmiddle, fout, 3, padding=1)
        kw = dict(compute_dtype=compute_dtype)
        self.norm_0 = SPADE(fin, label_nc, **kw)
        self.norm_1 = SPADE(fmiddle, label_nc, **kw)
        if self.learned_shortcut:
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)
            self.norm_s = SPADE(fin, label_nc, **kw)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x_s = x
        if self.learned_shortcut:
            x_s = conv_layer(self.norm_s(x, seg), self.conv_s,
                             compute_dtype=cd)
        dx = conv_layer(F.leaky_relu(self.norm_0(x, seg), SLOPE),
                        self.conv_0, compute_dtype=cd)
        dx = conv_layer(F.leaky_relu(self.norm_1(dx, seg), SLOPE),
                        self.conv_1, compute_dtype=cd)
        return x_s + dx


class SPADEGenerator(nn.Module):

    def __init__(self, input_dim: int = 3, output_dim: int = 3, nf: int = 64,
                 activation: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype)
        self.fc = nn.Conv2d(input_dim, 16 * nf, 3, padding=1)
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf, input_dim, **kw)
        self.G_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf, input_dim, **kw)
        self.G_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf, input_dim, **kw)
        self.up_0 = SPADEResnetBlock(16 * nf, 8 * nf, input_dim, **kw)
        self.up_1 = SPADEResnetBlock(8 * nf, 4 * nf, input_dim, **kw)
        self.up_2 = SPADEResnetBlock(4 * nf, 2 * nf, input_dim, **kw)
        self.up_3 = SPADEResnetBlock(2 * nf, nf, input_dim, **kw)
        self.conv_img = nn.Conv2d(nf, output_dim, 3, padding=1)

    def forward(self, seg: torch.Tensor) -> torch.Tensor:
        """seg: (N, H, W, input_dim) float32, H and W multiples of 32 ->
        (N, H, W, output_dim) float32."""
        cd = self.compute_dtype
        x = conv_layer(downsample_nearest(seg, 2 ** UPSAMPLINGS), self.fc,
                       compute_dtype=cd)
        x = self.head_0(x, seg)
        x = upsample_nearest2(x)
        x = self.G_middle_0(x, seg)
        x = self.G_middle_1(x, seg)
        for block in (self.up_0, self.up_1, self.up_2, self.up_3):
            x = block(upsample_nearest2(x), seg)
        y = conv_layer(F.leaky_relu(x, SLOPE), self.conv_img,
                       compute_dtype=cd)
        return torch.tanh(y) if self.activation else y
