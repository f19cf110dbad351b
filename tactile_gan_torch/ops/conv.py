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
conv, as the JAX package computes it in XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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
