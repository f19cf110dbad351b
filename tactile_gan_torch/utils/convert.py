"""Carry weights and Adam state between the JAX package's trees and the
port.

UNet++: the JAX tree (numpy arrays) is ``node{r}_{c}/{a,b}/{conv/kernel
(HWIO), norm/scale, norm/offset}`` and ``head/proj/{kernel, bias}``; the
port's ``state_dict`` uses the PyTorch reference's names and layouts (OIHW
conv weights, norm weight/bias). ``unetpp_state_dict_from_jax`` is the
inverse of ``tactile_gan_tpu/utils/torch_migrate.py`` ``unetpp_from_torch``;
``unetpp_jax_params_from_state_dict`` is the same mapping as that function,
kept here so the port needs nothing of the JAX package. The
PatchDiscriminator pair mirrors ``patchdisc_from_torch`` the same way.

Adam: optax keeps (count, mu, nu) with mu and nu shaped like the params;
torch keeps per parameter (step, exp_avg, exp_avg_sq). The moments map
through the same name/layout conversion as the weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

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


# (JAX module, torch conv index, torch norm index or None)
_DISC = (("block1_conv", 0, None), ("block2_conv", 2, 3),
         ("block3_conv", 5, 6), ("block4_conv", 8, 9),
         ("patch_head", 11, None))


def _norm_name(conv_name: str) -> str:
    return conv_name.replace("_conv", "_norm")


def patchdisc_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX PatchDiscriminator params (optionally under 'params') -> the
    port's state_dict (float32 CPU tensors)."""
    p = params.get("params", params)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {}
    for name, ci, ni in _DISC:
        sd[f"model.{ci}.weight"] = t(p[name]["kernel"]).permute(3, 2, 0, 1).contiguous()
        if "bias" in p[name]:
            sd[f"model.{ci}.bias"] = t(p[name]["bias"])
        if ni is not None:
            norm = p[_norm_name(name)]
            sd[f"model.{ni}.weight"] = t(norm["scale"])
            sd[f"model.{ni}.bias"] = t(norm["offset"])
    return sd


def patchdisc_jax_params_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's PatchDiscriminator state_dict -> the JAX param tree."""

    def a(name: str) -> np.ndarray:
        return sd[name].detach().cpu().float().numpy()

    p = {}
    for name, ci, ni in _DISC:
        p[name] = {"kernel": a(f"model.{ci}.weight").transpose(2, 3, 1, 0)}
        if f"model.{ci}.bias" in sd:
            p[name]["bias"] = a(f"model.{ci}.bias")
        if ni is not None:
            p[_norm_name(name)] = {"scale": a(f"model.{ni}.weight"),
                                   "offset": a(f"model.{ni}.bias")}
    return p


def load_adam_state(opt: torch.optim.Adam, model: torch.nn.Module,
                    mu: Mapping, nu: Mapping, count: int,
                    to_state_dict: Callable[[Mapping], Dict[str, torch.Tensor]]
                    ) -> None:
    """Set ``opt``'s state for ``model``'s parameters from optax Adam state:
    ``mu`` and ``nu`` are param-shaped JAX trees, ``count`` the update
    count, ``to_state_dict`` the model's weight conversion (e.g.
    ``unetpp_state_dict_from_jax``)."""
    mu_sd, nu_sd = to_state_dict(mu), to_state_dict(nu)
    for name, p in model.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu_sd[name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu_sd[name].to(p.device, p.dtype).clone()}


def adam_moments(opt: torch.optim.Adam, model: torch.nn.Module,
                 from_state_dict: Callable[[Mapping], dict]
                 ) -> Tuple[dict, dict, int]:
    """The inverse of ``load_adam_state``: (mu, nu, count) as JAX trees."""
    mu_sd, nu_sd, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = opt.state[p]
        mu_sd[name], nu_sd[name] = st["exp_avg"], st["exp_avg_sq"]
        count = int(st["step"])
    return from_state_dict(mu_sd), from_state_dict(nu_sd), count
