"""NHWC convolution with the JAX package's dtype policy.

Activations are NHWC and weights OIHW (the PyTorch reference's layout, so
``state_dict``s carry over unchanged). With a low-precision
``compute_dtype`` both operands are cast to it, the product accumulates in
float32 inside the library conv, its low-precision output is upcast to
float32 between ops, and the bias is added after (the policy of
``tactile_gan_tpu/ops/conv.py`` ``conv2d``). The deep rows of the generator
run this library conv; the full-resolution 3x3 convs run the hand-written
kernel in ``ops/kernels/conv3x3.py``. ``conv2d_transpose`` (UNet's and
BCDUNet's up-convs) follows the same policy with the library's transposed
conv, as the JAX package computes it in XLA. ``conv_layer`` runs a layer
module through the right one of these (or kernel B), and a layer split over
the model axis (``parallel/tensor_parallel.py``) on its slice between the
model group's collectives.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tactile_gan_torch.ops.kernels import conv3x3 as kb
from tactile_gan_torch.parallel.tensor_parallel import split_conv


def conv2d(x: torch.Tensor, weight: torch.Tensor, *, stride: int = 1,
           padding: int = 0, bias: Optional[torch.Tensor] = None,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x: (N,H,W,Cin), weight: (Cout,Cin,kh,kw) -> (N,H',W',Cout) float32."""
    xc = x.permute(0, 3, 1, 2).to(compute_dtype)  # NCHW view, NHWC memory
    out = F.conv2d(xc, weight.to(compute_dtype), stride=stride,
                   padding=padding)
    out = out.permute(0, 2, 3, 1).contiguous().float()
    if bias is not None:
        out = out + bias.float()
    return out


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor, *,
                     stride: int = 2, padding: int = 0,
                     bias: Optional[torch.Tensor] = None,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """nn.ConvTranspose2d(k, stride, padding) on NHWC: x (N,H,W,Cin),
    weight (Cin,Cout,kh,kw) -> (N,(H-1)*stride-2*padding+kh,...,Cout)
    float32."""
    xc = x.permute(0, 3, 1, 2).to(compute_dtype)
    out = F.conv_transpose2d(xc, weight.to(compute_dtype), stride=stride,
                             padding=padding)
    out = out.permute(0, 2, 3, 1).contiguous().float()
    if bias is not None:
        out = out + bias.float()
    return out


def conv_layer(x: torch.Tensor, layer: nn.Module, *,
               compute_dtype: torch.dtype = torch.float32,
               kernel: bool = False) -> torch.Tensor:
    """``layer`` (an ``nn.Conv2d`` or ``nn.ConvTranspose2d``: its weight,
    bias, stride and padding) on NHWC ``x``: the library conv or transposed
    conv, or with ``kernel`` kernel B (a bias-free 3x3/s1/p1 conv)."""
    def run(x):
        if kernel:
            return kb.conv3x3(x, layer.weight, compute_dtype=compute_dtype)
        fn = (conv2d_transpose if isinstance(layer, nn.ConvTranspose2d)
              else conv2d)
        return fn(x, layer.weight, stride=layer.stride[0],
                  padding=layer.padding[0], bias=layer.bias,
                  compute_dtype=compute_dtype)

    return split_conv(layer, x, run)
