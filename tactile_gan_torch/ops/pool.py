"""2x2 stride-2 average pooling on NHWC tensors (nn.AvgPool2d(2, 2))."""

from __future__ import annotations

import torch


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"avg_pool2 needs even H and W, got {tuple(x.shape)}")
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
