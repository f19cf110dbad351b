"""Checkpoint IO in the PyTorch reference's ``final_model.pth`` layout.

The port writes ``torch.save`` archives of the reference's four keys,
``gen``, ``disc``, ``optimizerG_state_dict`` and ``optimizerD_state_dict``
(the optimizers' own ``state_dict``s), plus ``step``; the JAX package's
``load_checkpoint`` reads their weights. ``AsyncCheckpointer`` writes them
on a background thread, after the caller has copied the state to the host.

``load_checkpoint`` reads both formats. A torch archive loads with
``torch.load(weights_only=True)``. A file the JAX package wrote is flax's
msgpack (``flax.serialization.msgpack_serialize``), decoded here with plain
``msgpack`` (neither flax nor jax is needed) and converted to the port's
layout through ``utils/convert.py``: ``gen`` by the table of the generator
the tree holds (UNet++, UNet or BCDUNet, told apart by its first module),
``disc`` by the PatchDiscriminator's, and each optax Adam state (the
state-dict form of ``optax.adam``'s chain: ``{"0": {count, mu, nu}, "1":
...}``) into ``{"count", "mu", "nu"}`` with the moments in the port's
parameter names, which ``train/loop.py`` loads through ``load_adam_state``.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from tactile_gan_torch.utils.convert import state_dict_from_jax

# torch >= 1.6 archives are zip files; legacy ones start with a pickle tag.
_TORCH_MAGIC = (b"PK", b"\x80\x02", b"\x80\x03", b"\x80\x04", b"\x80\x05")

# flax.serialization's msgpack ext type codes.
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# The marker of a leaf flax split into chunks (leaves over 2**30 bytes).
_CHUNKED = "__msgpack_chunked_array__"

# The first parameter module of each JAX generator: which one a tree is.
_JAX_GENERATORS = (("node0_0", "UNet++"), ("down1", "UNet"),
                   ("enc1", "BCDUNet"))


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _payload(gen, disc, opt_g, opt_d, step) -> Dict[str, Any]:
    """The checkpoint's dictionary, every tensor on the host; keys given as
    None are left out."""
    payload = {"gen": _to_cpu(dict(gen))}
    for key, value in (("disc", disc), ("optimizerG_state_dict", opt_g),
                       ("optimizerD_state_dict", opt_d)):
        if value is not None:
            payload[key] = _to_cpu(dict(value))
    if step is not None:
        payload["step"] = int(step)
    return payload


def _write(path: str, payload: Dict[str, Any]) -> None:
    """torch.save, atomically (tmp file + rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, *, gen: Mapping[str, torch.Tensor],
                    disc: Optional[Mapping[str, torch.Tensor]] = None,
                    opt_g: Optional[dict] = None, opt_d: Optional[dict] = None,
                    step: Optional[int] = None) -> None:
    """Write the checkpoint atomically; the keys given as None are left
    out."""
    _write(path, _payload(gen, disc, opt_g, opt_d, step))


class AsyncCheckpointer:
    """Background-thread checkpoint writer, as the JAX package's: ``save``
    copies the state to the host on the caller, then serializes and writes
    on one worker thread while training goes on. One save in flight at a
    time; ``wait()`` before reading the file back or exiting."""

    def __init__(self):
        self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="checkpoint")
        self._pending: Optional[cf.Future] = None

    def save(self, path: str, *, gen, disc=None, opt_g=None, opt_d=None,
             step=None) -> None:
        self.wait()
        payload = _payload(gen, disc, opt_g, opt_d, step)
        self._pending = self._pool.submit(_write, path, payload)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()


def is_torch_checkpoint(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) in _TORCH_MAGIC


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack of (shape, dtype name, C-order
    bytes). bfloat16, which numpy lacks, widens exactly to float32."""
    import msgpack

    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    return msgpack.ExtType(code, data)


def _refuse_chunked(tree: Any, path: str = "") -> None:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise NotImplementedError(
                f"the msgpack checkpoint splits the leaf {path!r} into "
                "chunks (flax does so above 2**30 bytes); chunked leaves are "
                "not read (no leaf of the generators or the PatchGAN comes "
                "near that size)")
        for k, v in tree.items():
            _refuse_chunked(v, f"{path}/{k}")


def read_msgpack(path: str) -> Dict[str, Any]:
    """The raw tree of a flax msgpack file: dicts of numpy arrays."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    _refuse_chunked(tree)
    return tree


def jax_generator_name(params: Mapping) -> str:
    """Which JAX generator a param tree (optionally under 'params') is."""
    p = params.get("params", params)
    for first, name in _JAX_GENERATORS:
        if first in p:
            return name
    raise ValueError(f"not a JAX generator tree: {sorted(p)[:8]}")


def _adam(state: Mapping, net: str) -> Dict[str, Any]:
    """optax.adam's chain state in state-dict form -> count and the
    moments of ``net`` in the port's parameter names."""
    adam = state["0"]
    return {"count": int(adam["count"]),
            "mu": state_dict_from_jax(adam["mu"], net),
            "nu": state_dict_from_jax(adam["nu"], net)}


def convert_jax_checkpoint(tree: Mapping) -> Dict[str, Any]:
    """The JAX package's checkpoint tree -> the port's layout."""
    gen = jax_generator_name(tree["gen"])
    out: Dict[str, Any] = {"gen": state_dict_from_jax(tree["gen"], gen)}
    if tree.get("disc"):
        out["disc"] = state_dict_from_jax(tree["disc"], "patch")
    for key, net in (("optimizerG_state_dict", gen),
                     ("optimizerD_state_dict", "patch")):
        if tree.get(key):
            out[key] = _adam(tree[key], net)
    if "step" in tree:
        out["step"] = int(tree["step"])
    return out


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint of either format into the port's layout."""
    if is_torch_checkpoint(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    return convert_jax_checkpoint(read_msgpack(path))
