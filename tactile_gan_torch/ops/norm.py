"""Instance normalization on NHWC tensors (nn.InstanceNorm2d semantics).

Biased variance over (H, W) per (N, C), computed two-pass, eps 1e-5, with
float32 statistics whatever the activation dtype. This is the plain
function; the fused card kernel lives in ``ops/kernels/instance_norm.py``.
"""

from __future__ import annotations

from typing import Optional

import torch


def instance_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (N,H,W,C); weight/bias: (C,) or None (non-affine)."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y if x.dtype == torch.float32 else y.to(x.dtype)
