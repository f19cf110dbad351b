"""SPADE's generator (GauGAN) in plain NCHW ``torch.nn`` at float32, written
from the equations of Park et al., "Semantic Image Synthesis with
Spatially-Adaptive Normalization" (CVPR 2019, arXiv:1903.07291) and
NVlabs/SPADE ``models/networks/{generator,architecture,normalization}.py``
at ``--ngf 64 --num_upsampling_layers normal --norm_G
spadeinstance3x3``, no VAE, the input as its own segmentation map. The
port's ``tactile_gan_torch/models/spade.py`` is held to it; nothing of the
port is imported here. Parameter names are NVlabs/SPADE's, which are the
port's ``state_dict`` keys.
"""

import torch
import torch.nn.functional as F
from torch import nn

HIDDEN = 128
UPSAMPLINGS = 5
SLOPE = 0.2


class SPADE(nn.Module):
    def __init__(self, norm_nc, label_nc):
        super().__init__()
        self.param_free_norm = nn.InstanceNorm2d(norm_nc, affine=False)
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, HIDDEN, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(HIDDEN, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(HIDDEN, norm_nc, 3, padding=1)

    def forward(self, x, seg):
        normalized = self.param_free_norm(x)
        seg = F.interpolate(seg, size=x.shape[2:], mode="nearest")
        actv = self.mlp_shared(seg)
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin, fout, label_nc):
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

    def forward(self, x, seg):
        x_s = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut \
            else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), SLOPE))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), SLOPE))
        return x_s + dx


class SPADEGenerator(nn.Module):
    def __init__(self, input_dim=3, output_dim=3, nf=64):
        super().__init__()
        self.fc = nn.Conv2d(input_dim, 16 * nf, 3, padding=1)
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf, input_dim)
        self.G_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf, input_dim)
        self.G_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf, input_dim)
        self.up_0 = SPADEResnetBlock(16 * nf, 8 * nf, input_dim)
        self.up_1 = SPADEResnetBlock(8 * nf, 4 * nf, input_dim)
        self.up_2 = SPADEResnetBlock(4 * nf, 2 * nf, input_dim)
        self.up_3 = SPADEResnetBlock(2 * nf, nf, input_dim)
        self.conv_img = nn.Conv2d(nf, output_dim, 3, padding=1)
        self.up = nn.Upsample(scale_factor=2)

    def forward(self, seg):
        h, w = seg.shape[2:]
        x = F.interpolate(seg, size=(h >> UPSAMPLINGS, w >> UPSAMPLINGS))
        x = self.head_0(self.fc(x), seg)
        x = self.up(x)
        x = self.G_middle_0(x, seg)
        x = self.G_middle_1(x, seg)
        for block in (self.up_0, self.up_1, self.up_2, self.up_3):
            x = block(self.up(x), seg)
        return torch.tanh(self.conv_img(F.leaky_relu(x, SLOPE)))
