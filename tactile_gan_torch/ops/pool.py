"""2x2 stride-2 pooling on NHWC tensors: average (nn.AvgPool2d(2, 2), the
UNet++ downsampling) and max (nn.MaxPool2d(2, 2), the VGG tower)."""

from __future__ import annotations

import torch


def _windows(x: torch.Tensor, what: str) -> torch.Tensor:
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"{what} needs even H and W, got {tuple(x.shape)}")
    return x.reshape(n, h // 2, 2, w // 2, 2, c)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return _windows(x, "avg_pool2").mean(dim=(2, 4))


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    return _windows(x, "max_pool2").amax(dim=(2, 4))
