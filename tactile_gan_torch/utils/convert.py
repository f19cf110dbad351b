"""Carry weights and Adam state between the JAX package's trees and the
port.

Each network is a table of leaves: (the leaf's path in the JAX tree, its
name in the port's ``state_dict``, its layout). The JAX trees hold numpy
arrays with HWIO conv kernels, instance-norm ``scale`` / ``offset`` and
conv ``bias``; the port's ``state_dict`` uses the PyTorch reference's names
and layouts: OIHW conv weights, IOHW transposed-conv weights (carried with
no flip: the JAX ``conv2d_transpose`` flips its kernel itself), norm
``weight`` / ``bias``. For each of UNet++, UNet, BCDUNet and the
PatchDiscriminator, ``*_state_dict_from_jax`` is the inverse of
``tactile_gan_tpu/utils/torch_migrate.py``'s ``*_from_torch`` and
``*_jax_params_from_state_dict`` the same mapping as that function, kept
here so the port needs nothing of the JAX package. BCDUNet's JAX tree has
no norm parameters (its norms are not affine).

Adam: optax keeps (count, mu, nu) with mu and nu shaped like the params;
torch keeps per parameter (step, exp_avg, exp_avg_sq). The moments map
through the same table as the weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from tactile_gan_torch.models.unet import STAGES
from tactile_gan_torch.models.unet_plusplus import ROWS

# (JAX path, torch name, layout): "oihw" conv, "iohw" transposed conv,
# "vec" bias or norm parameter.
Leaf = Tuple[Tuple[str, ...], str, str]
# HWIO from each torch layout; the inverse permutation goes back.
_TO_HWIO = {"oihw": (2, 3, 1, 0), "iohw": (2, 3, 0, 1)}
_FROM_HWIO = {"oihw": (3, 2, 0, 1), "iohw": (2, 3, 0, 1)}


def _conv(path: Tuple[str, ...], name: str, bias: bool,
          layout: str = "oihw") -> Iterator[Leaf]:
    yield path + ("kernel",), f"{name}.weight", layout
    if bias:
        yield path + ("bias",), f"{name}.bias", "vec"


def _norm(path: Tuple[str, ...], name: str) -> Iterator[Leaf]:
    yield path + ("scale",), f"{name}.weight", "vec"
    yield path + ("offset",), f"{name}.bias", "vec"


def _cnr(path: Tuple[str, ...], conv: str, norm: str) -> Iterator[Leaf]:
    """A ConvNormRelu unit: bias-free conv, affine norm."""
    yield from _conv(path + ("conv",), conv, False)
    yield from _norm(path + ("norm",), norm)


def _unetpp() -> Iterator[Leaf]:
    for row in range(ROWS):
        for col in range(ROWS - row):
            base = f"conv{row}_{col}.layer"
            yield from _cnr((f"node{row}_{col}", "a"), f"{base}.0",
                            f"{base}.1")
            yield from _cnr((f"node{row}_{col}", "b"), f"{base}.3",
                            f"{base}.4")
    yield from _conv(("head", "proj"), "downfeature.conv", True)


def _unet() -> Iterator[Leaf]:
    for i in range(1, STAGES + 1):
        base = f"conv{i}.layer"
        yield from _cnr((f"down{i}", "down"), f"{base}.0", f"{base}.1")
        yield from _cnr((f"down{i}", "refine"), f"{base}.3", f"{base}.4")
    for i in range(1, STAGES + 1):  # the JAX up{i} is deconv{i+1}
        base = f"deconv{i + 1}.layer"
        yield from _conv((f"up{i}", "up"), f"{base}.0", False, "iohw")
        yield from _norm((f"up{i}", "norm"), f"{base}.1")
        yield from _cnr((f"up{i}", "refine"), f"{base}.3", f"{base}.4")
    yield from _conv(("head", "proj"), "downfeature.conv", True)


def _bcdunet() -> Iterator[Leaf]:
    def block(path, name):
        yield from _conv((path, "a", "conv"), f"{name}.0", True)
        yield from _conv((path, "b", "conv"), f"{name}.3", True)

    for i in range(1, 5):
        yield from block(f"enc{i}", f"conv{i}")
    for i in range(1, 4):
        yield from _conv((f"up{i}",), f"upconv{i}", True, "iohw")
        yield from block(f"dec{i}", f"conv{i}m")
    yield from _conv(("head", "proj"), "conv0", True)


def _patchdisc() -> Iterator[Leaf]:
    yield from _conv(("block1_conv",), "model.0", True)
    for k, (ci, ni) in enumerate(((2, 3), (5, 6), (8, 9)), start=2):
        yield from _conv((f"block{k}_conv",), f"model.{ci}", False)
        yield from _norm((f"block{k}_norm",), f"model.{ni}")
    yield from _conv(("patch_head",), "model.11", True)


LEAVES = {"UNet++": tuple(_unetpp()), "UNet": tuple(_unet()),
          "BCDUNet": tuple(_bcdunet()), "patch": tuple(_patchdisc())}


def state_dict_from_jax(params: Mapping, net: str
                        ) -> Dict[str, torch.Tensor]:
    """JAX params of ``net`` (a key of LEAVES; optionally under a 'params'
    key) -> the port's state_dict (float32 CPU tensors)."""
    p = params.get("params", params)
    sd = {}
    for path, name, layout in LEAVES[net]:
        leaf = p
        for k in path:
            leaf = leaf[k]
        a = np.array(leaf, dtype=np.float32)
        if layout != "vec":
            a = np.ascontiguousarray(a.transpose(_FROM_HWIO[layout]))
        sd[name] = torch.from_numpy(a)
    return sd


def jax_params_from_state_dict(sd: Mapping[str, torch.Tensor],
                               net: str) -> dict:
    """The port's state_dict of ``net`` -> the JAX param tree of numpy
    arrays."""
    p: dict = {}
    for path, name, layout in LEAVES[net]:
        a = sd[name].detach().cpu().float().numpy()
        if layout != "vec":
            a = a.transpose(_TO_HWIO[layout])
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return p


def unetpp_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    return state_dict_from_jax(params, "UNet++")


def unetpp_jax_params_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    return jax_params_from_state_dict(sd, "UNet++")


def unet_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    return state_dict_from_jax(params, "UNet")


def unet_jax_params_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    return jax_params_from_state_dict(sd, "UNet")


def bcdunet_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    return state_dict_from_jax(params, "BCDUNet")


def bcdunet_jax_params_from_state_dict(sd: Mapping[str, torch.Tensor]
                                       ) -> dict:
    return jax_params_from_state_dict(sd, "BCDUNet")


def patchdisc_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    return state_dict_from_jax(params, "patch")


def patchdisc_jax_params_from_state_dict(sd: Mapping[str, torch.Tensor]
                                         ) -> dict:
    return jax_params_from_state_dict(sd, "patch")


def load_adam_state(opt: torch.optim.Adam, model: torch.nn.Module,
                    mu: Mapping, nu: Mapping, count: int,
                    to_state_dict: Callable[[Mapping], Dict[str, torch.Tensor]]
                    ) -> None:
    """Set ``opt``'s state for ``model``'s parameters from optax Adam state:
    ``mu`` and ``nu`` are param-shaped JAX trees, ``count`` the update
    count, ``to_state_dict`` the model's weight conversion (e.g.
    ``unetpp_state_dict_from_jax``). A capturable optimizer keeps its step
    counts as float32 on the parameters' device, as torch's own
    ``load_state_dict`` places them; any other keeps them on the CPU."""
    mu_sd, nu_sd = to_state_dict(mu), to_state_dict(nu)
    capturable = opt.param_groups[0].get("capturable", False)
    for name, p in model.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if capturable else "cpu"),
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
