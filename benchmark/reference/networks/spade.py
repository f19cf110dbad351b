"""SPADE's generator (GauGAN), written from Park et al., "Semantic Image
Synthesis with Spatially-Adaptive Normalization" (CVPR 2019,
arXiv:1903.07291) and NVlabs/SPADE ``models/networks/generator.py``
``SPADEGenerator``, ``architecture.py`` ``SPADEResnetBlock`` and
``normalization.py`` ``SPADE`` at ``--ngf 64 --num_upsampling_layers
normal --norm_G spadeinstance3x3`` with no VAE, the generator's input as
its segmentation map:

- SPADE(C): x_hat = IN(x) (non-affine); s = nearest(seg, x's size); a =
  ReLU(conv3x3(s; -> 128)); x_hat * (1 + conv3x3(a; 128 -> C)) +
  conv3x3(a; 128 -> C);
- a block (fin, fout), fm = min(fin, fout): dx = conv3x3(lrelu(SPADE(fin)
  (x)); fin -> fm), dx = conv3x3(lrelu(SPADE(fm)(dx)); fm -> fout); x_s =
  conv1x1(SPADE(fin)(x); bias-free) where fin != fout, else x; x_s + dx;
- fc = conv3x3(nearest(seg, H/32); -> 16 nf), head_0, 2x up, G_middle_0,
  G_middle_1, then 2x up before each of up_0 .. up_3 (16nf -> 8nf -> 4nf
  -> 2nf -> nf), tanh(conv3x3(lrelu(x); nf -> 3)); LeakyReLU slope 0.2.

Eighteen parameter-free instance norms a forward, each recorded through
``norm_act``. Parameter names are NVlabs/SPADE's, the port's
``state_dict`` keys. The published constants (the 128-wide shared conv,
five upsamplings, the 16 nf trunk, 3x3 kernels) are the classes' own.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models import NormRecorder, conv, norm_act

NAME = "SPADE"
ROLE = "gen"
CPU_TEST_SIZE = 64  # the trunk starts at H/32: 2x2 (at 32 px, 1x1 norms)

HIDDEN = 128
UPSAMPLINGS = 5
SLOPE = 0.2


class SPADE(nn.Module):
    def __init__(self, norm_nc: int, label_nc: int):
        super().__init__()
        self.param_free_norm = nn.InstanceNorm2d(norm_nc, affine=False)
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, HIDDEN, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(HIDDEN, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(HIDDEN, norm_nc, 3, padding=1)

    def forward(self, x, seg, prec: str,
                recorder: Optional[NormRecorder]) -> torch.Tensor:
        normalized = norm_act(x, self.param_free_norm, recorder, None)
        s = F.interpolate(seg, size=x.shape[2:], mode="nearest")
        a = torch.relu(conv(s, self.mlp_shared[0], prec))
        return (normalized * (1 + conv(a, self.mlp_gamma, prec))
                + conv(a, self.mlp_beta, prec))


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin: int, fout: int, label_nc: int):
        super().__init__()
        self.learned_shortcut = fin != fout
        fmiddle = min(fin, fout)
        self.conv_0 = nn.Conv2d(fin, fmiddle, 3, padding=1)
        self.conv_1 = nn.Conv2d(fmiddle, fout, 3, padding=1)
        self.norm_0 = SPADE(fin, label_nc)
        self.norm_1 = SPADE(fmiddle, label_nc)
        if self.learned_shortcut:
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)
            self.norm_s = SPADE(fin, label_nc)

    def forward(self, x, seg, prec: str,
                recorder: Optional[NormRecorder]) -> torch.Tensor:
        x_s = x
        if self.learned_shortcut:
            x_s = conv(self.norm_s(x, seg, prec, recorder), self.conv_s, prec)
        dx = conv(F.leaky_relu(self.norm_0(x, seg, prec, recorder), SLOPE),
                  self.conv_0, prec)
        dx = conv(F.leaky_relu(self.norm_1(dx, seg, prec, recorder), SLOPE),
                  self.conv_1, prec)
        return x_s + dx


class SPADEGenerator(nn.Module):
    def __init__(self, input_dim: int = 3, output_dim: int = 3,
                 nf: int = 64, prec: str = "f32"):
        super().__init__()
        self.prec = prec
        self.recorder: Optional[NormRecorder] = None
        self.fc = nn.Conv2d(input_dim, 16 * nf, 3, padding=1)
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf, input_dim)
        self.G_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf, input_dim)
        self.G_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf, input_dim)
        self.up_0 = SPADEResnetBlock(16 * nf, 8 * nf, input_dim)
        self.up_1 = SPADEResnetBlock(8 * nf, 4 * nf, input_dim)
        self.up_2 = SPADEResnetBlock(4 * nf, 2 * nf, input_dim)
        self.up_3 = SPADEResnetBlock(2 * nf, nf, input_dim)
        self.conv_img = nn.Conv2d(nf, output_dim, 3, padding=1)

    def forward(self, seg: torch.Tensor) -> torch.Tensor:
        prec, rec = self.prec, self.recorder
        h, w = seg.shape[2:]
        x = F.interpolate(seg, size=(h >> UPSAMPLINGS, w >> UPSAMPLINGS),
                          mode="nearest")
        x = self.head_0(conv(x, self.fc, prec), seg, prec, rec)
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = self.G_middle_0(x, seg, prec, rec)
        x = self.G_middle_1(x, seg, prec, rec)
        for block in (self.up_0, self.up_1, self.up_2, self.up_3):
            x = block(F.interpolate(x, scale_factor=2, mode="nearest"), seg,
                      prec, rec)
        return torch.tanh(conv(F.leaky_relu(x, SLOPE), self.conv_img, prec))


NETWORK = SPADEGenerator
