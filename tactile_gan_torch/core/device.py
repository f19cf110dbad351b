"""Device policy: the port runs on the card unless the caller asks for the CPU.

There is no silent fallback. ``device="cuda"`` on a host without a usable
CUDA device raises; ``device="cpu"`` runs every kernel's plain PyTorch
version (the tests do this).
"""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device] = DEFAULT_DEVICE
                   ) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but no CUDA device is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev
