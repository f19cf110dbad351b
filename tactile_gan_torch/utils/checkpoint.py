"""Checkpoint IO in the PyTorch reference's ``final_model.pth`` layout.

Files are ``torch.save({"gen": state_dict, ...})`` archives, which the JAX
package's ``load_checkpoint`` also reads. Loading uses
``torch.load(weights_only=True)``. The JAX package's own msgpack
checkpoints are not read yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch

# torch >= 1.6 archives are zip files; legacy ones start with a pickle tag.
_TORCH_MAGIC = (b"PK", b"\x80\x02", b"\x80\x03", b"\x80\x04", b"\x80\x05")


def save_checkpoint(path: str, *, gen: Mapping[str, torch.Tensor]) -> None:
    """Write {'gen': state_dict} atomically (tmp file + rename)."""
    payload = {"gen": {k: v.detach().cpu() for k, v in gen.items()}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic not in _TORCH_MAGIC:
        raise NotImplementedError(
            f"{path} is not a torch checkpoint; the msgpack checkpoints of "
            "the JAX package are not read by the port yet (ROADMAP.md, "
            "queue 1: the msgpack checkpoint reader)")
    return torch.load(path, map_location="cpu", weights_only=True)

