"""UNet generator (``--gen UNet``).

Follows ``tactile_gan_tpu/models/unet.py``: a 7-stage stride-2 encoder of
widths nf, 2nf, 4nf, 8nf, 8nf, 8nf, 8nf (256 px down to 2 px), a decoder of
transposed convs that concatenates each encoder stage's output on the
channel axis, and a 1x1 head with optional Tanh. Every norm runs kernel A
(C in the backward); every conv and transposed conv runs the library's, as
the JAX package runs them on XLA.

Input and output are NHWC float32. Module names are the PyTorch
reference's (``conv{1..7}.layer``, ``deconv{2..8}.layer``,
``downfeature.conv``), so the JAX package's ``load_checkpoint`` reads this
model's ``state_dict`` unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from tactile_gan_torch.models.blocks import DownBlock, Head, UpBlock

STAGES = 7
MIN_SIZE = 2 ** (STAGES + 1)  # 256: a 2x2 bottleneck


class UNet(nn.Module):

    def __init__(self, input_dim: int = 3, output_dim: int = 3, nf: int = 64,
                 activation: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        enc = [nf, nf * 2, nf * 4, nf * 8, nf * 8, nf * 8, nf * 8]
        for i, (cin, w) in enumerate(zip([input_dim] + enc[:-1], enc),
                                     start=1):
            self.add_module(f"conv{i}", DownBlock(
                cin, w, compute_dtype=compute_dtype))
        # deconv2 takes the bottleneck; each later one its predecessor's
        # output beside the encoder stage of the same size.
        dec = [nf * 8, nf * 8, nf * 8, nf * 4, nf * 2, nf, nf]
        cins = [enc[-1]] + [d + e for d, e in zip(dec[:-1],
                                                  reversed(enc[:-1]))]
        for i, (cin, w) in enumerate(zip(cins, dec), start=2):
            self.add_module(f"deconv{i}", UpBlock(
                cin, w, compute_dtype=compute_dtype))
        self.downfeature = Head(nf, output_dim, activation=activation,
                                compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, input_dim) float32, H and W >= 256 -> (N, H, W,
        output_dim) float32."""
        if x.shape[1] < MIN_SIZE or x.shape[2] < MIN_SIZE:
            # Seven stride-2 stages: at 128 px the bottleneck is 1x1, where
            # instance norm is degenerate and the reference errors.
            raise ValueError(
                f"UNet needs inputs of at least {MIN_SIZE}x{MIN_SIZE} "
                f"({STAGES} stride-2 stages; the reference errors below "
                f"that); got {x.shape[1]}x{x.shape[2]}. Use UNet++ or "
                "BCDUNet for smaller images.")
        skips = []
        for i in range(1, STAGES + 1):
            x = getattr(self, f"conv{i}")(x)
            skips.append(x)
        x = self.deconv2(skips[-1])
        for i, skip in zip(range(3, STAGES + 2), reversed(skips[:-1])):
            x = getattr(self, f"deconv{i}")(torch.cat([x, skip], dim=-1))
        return self.downfeature(x)
