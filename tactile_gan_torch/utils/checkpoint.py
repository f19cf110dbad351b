"""Checkpoint IO in the PyTorch reference's ``final_model.pth`` layout.

Files are ``torch.save`` archives of the reference's four keys, ``gen``,
``disc``, ``optimizerG_state_dict`` and ``optimizerD_state_dict`` (the
optimizers' own ``state_dict``s), plus ``step``; the JAX package's
``load_checkpoint`` reads their weights. Loading uses
``torch.load(weights_only=True)``. The JAX package's own msgpack
checkpoints are not read yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

# torch >= 1.6 archives are zip files; legacy ones start with a pickle tag.
_TORCH_MAGIC = (b"PK", b"\x80\x02", b"\x80\x03", b"\x80\x04", b"\x80\x05")


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, *, gen: Mapping[str, torch.Tensor],
                    disc: Optional[Mapping[str, torch.Tensor]] = None,
                    opt_g: Optional[dict] = None, opt_d: Optional[dict] = None,
                    step: Optional[int] = None) -> None:
    """Write the checkpoint atomically (tmp file + rename); the keys given
    as None are left out."""
    payload = {"gen": _to_cpu(dict(gen))}
    for key, value in (("disc", disc), ("optimizerG_state_dict", opt_g),
                       ("optimizerD_state_dict", opt_d)):
        if value is not None:
            payload[key] = _to_cpu(dict(value))
    if step is not None:
        payload["step"] = int(step)
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

