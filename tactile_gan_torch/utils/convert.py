"""Carry UNet++ weights between the JAX package's param tree and the port.

The JAX tree (numpy arrays) is ``node{r}_{c}/{a,b}/{conv/kernel (HWIO),
norm/scale, norm/offset}`` and ``head/proj/{kernel, bias}``; the port's
``state_dict`` uses the PyTorch reference's names and layouts (OIHW conv
weights, norm weight/bias). ``unetpp_state_dict_from_jax`` is the inverse
of ``tactile_gan_tpu/utils/torch_migrate.py`` ``unetpp_from_torch``;
``unetpp_jax_params_from_state_dict`` is the same mapping as that function,
kept here so the port needs nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from tactile_gan_torch.models.unet_plusplus import ROWS

_UNITS = (("a", 0, 1), ("b", 3, 4))  # JAX unit name, conv index, norm index


def _nodes():
    for row in range(ROWS):
        for col in range(ROWS - row):
            yield row, col


def unetpp_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX UNetPlusPlus params (optionally under a 'params' key) -> the
    port's state_dict (float32 CPU tensors)."""
    p = params.get("params", params)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {}
    for row, col in _nodes():
        node = p[f"node{row}_{col}"]
        base = f"conv{row}_{col}.layer"
        for unit, ci, ni in _UNITS:
            u = node[unit]
            sd[f"{base}.{ci}.weight"] = t(u["conv"]["kernel"]).permute(3, 2, 0, 1).contiguous()
            sd[f"{base}.{ni}.weight"] = t(u["norm"]["scale"])
            sd[f"{base}.{ni}.bias"] = t(u["norm"]["offset"])
    proj = p["head"]["proj"]
    sd["downfeature.conv.weight"] = t(proj["kernel"]).permute(3, 2, 0, 1).contiguous()
    sd["downfeature.conv.bias"] = t(proj["bias"])
    return sd


def unetpp_jax_params_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict -> the JAX param tree of numpy arrays."""

    def a(name: str) -> np.ndarray:
        return sd[name].detach().cpu().float().numpy()

    p = {}
    for row, col in _nodes():
        base = f"conv{row}_{col}.layer"
        p[f"node{row}_{col}"] = {
            unit: {"conv": {"kernel": a(f"{base}.{ci}.weight").transpose(2, 3, 1, 0)},
                   "norm": {"scale": a(f"{base}.{ni}.weight"),
                            "offset": a(f"{base}.{ni}.bias")}}
            for unit, ci, ni in _UNITS}
    p["head"] = {"proj": {
        "kernel": a("downfeature.conv.weight").transpose(2, 3, 1, 0),
        "bias": a("downfeature.conv.bias")}}
    return p
