"""Tensor parallelism over the mesh's model axis (``shard_state_tp`` of
``tactile_gan_tpu/parallel/mesh.py``).

``shard_state_tp`` splits every ``nn.Conv2d`` / ``nn.ConvTranspose2d`` of
G and D with at least ``min_features`` output channels, divisible by
``n_model``, on its output channels: OIHW dim 0 for a conv, IOHW dim 1 for
a transposed conv, and the bias with it. Each rank of a model group then
holds one slice of the weight and of its Adam moments. Such a layer runs
Megatron-style (``split_conv``): its input goes through ``CopyToModel``
(identity forward, all-reduce of the gradient backward), the conv runs on
the slice, and the output is all-gathered on channels (backward: the
rank's own slice of the gradient). Everything downstream of the gather is
the same on every rank of the group: a parameter that is not split gets
the same gradient on each, up to the order of library sums, which
``parallel/mesh.py`` ``average_gradients`` evens out.

Each collective is a ``torch.autograd.Function`` whose backward applies the
other one, so the gradient penalty's double backward through D stays
differentiable. (``torch.distributed.nn``'s all-gather sums the gradient
over ranks in its backward: with every rank holding the same loss, that
would multiply it by ``n_model``.)

The JAX package sends its Pallas norms to XLA under a model axis; here the
norms keep kernels A and C, on the gathered (full) activations. Row 0
(nf <= 64 wide) is never split, so kernels B, B-dx and D run as before.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Tuple

import torch
import torch.distributed as dist
from torch import nn

from tactile_gan_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a split layer's slice lies: rank ``index`` of ``size`` in
    ``group``; ``dim`` is the weight's output-channel dim."""
    group: object
    index: int
    size: int
    dim: int


class CopyToModel(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x

    @staticmethod
    def backward(ctx, g):
        return ReduceFromModel.apply(g, ctx.shard), None


class ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        out = x.clone()
        dist.all_reduce(out, group=shard.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return CopyToModel.apply(g, ctx.shard), None


class GatherChannels(torch.autograd.Function):
    """All-gather of NHWC slices on the last dim; backward takes the rank's
    own slice."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(shard.size)]
        dist.all_gather(parts, x, group=shard.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return SliceChannels.apply(g, ctx.shard), None


class SliceChannels(torch.autograd.Function):
    """The rank's slice of the last dim; backward all-gathers."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        c = x.shape[-1] // shard.size
        return x[..., shard.index * c:(shard.index + 1) * c].contiguous()

    @staticmethod
    def backward(ctx, g):
        return GatherChannels.apply(g, ctx.shard), None


def split_conv(layer: nn.Module, x: torch.Tensor,
               conv: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``conv(x)`` for ``layer``: as is, or for a split layer between the
    model group's collectives."""
    shard = getattr(layer, "tp_shard", None)
    if shard is None:
        return conv(x)
    return GatherChannels.apply(conv(CopyToModel.apply(x, shard)), shard)


def _convs(module: nn.Module) -> Iterator[Tuple[str, nn.Module, int]]:
    for name, m in module.named_modules():
        if isinstance(m, nn.ConvTranspose2d):
            yield name, m, 1
        elif isinstance(m, nn.Conv2d):
            yield name, m, 0


def split_layers(module: nn.Module) -> Dict[str, nn.Module]:
    """name -> layer, for the split layers of ``module``."""
    return {name: m for name, m in module.named_modules()
            if getattr(m, "tp_shard", None) is not None}


@torch.no_grad()
def shard_state_tp(mesh: Mesh, state, min_features: int = 256) -> None:
    """Split the wide convs of ``state`` (a ``TrainState``) in place: each
    such layer keeps this rank's slice of its weight and bias, and each
    optimizer its slice of their Adam moments (where they exist yet). A
    no-op when the model axis is 1."""
    if mesh.n_model == 1:
        return
    for model, opt in ((state.gen, state.opt_g), (state.disc, state.opt_d)):
        for _, layer, dim in _convs(model):
            co = layer.weight.shape[dim]
            if co < min_features or co % mesh.n_model:
                continue
            shard = Shard(mesh.model_group, mesh.model_index, mesh.n_model,
                          dim)
            layer.tp_shard = shard
            for pname, pdim in (("weight", dim), ("bias", 0)):
                old = getattr(layer, pname)
                if old is None:
                    continue
                new = nn.Parameter(_slice(old, pdim, shard))
                new.tp_shard = shard
                setattr(layer, pname, new)
                _replace_in_optimizer(opt, old, new, pdim, shard)


def _slice(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    c = t.shape[dim] // shard.size
    return t.narrow(dim, shard.index * c, c).clone()


def _replace_in_optimizer(opt, old, new, dim, shard) -> None:
    for group in opt.param_groups:
        group["params"] = [new if p is old else p for p in group["params"]]
    st = opt.state.pop(old, None)
    if st is not None:
        opt.state[new] = {k: (_slice(v, dim, shard)
                              if torch.is_tensor(v) and v.shape == old.shape
                              else v) for k, v in st.items()}


def _gather(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=shard.group)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def full_state_dicts(state) -> dict:
    """``gen``, ``disc``, ``opt_g`` and ``opt_d`` state dicts of ``state``
    with every split tensor gathered to its full shape, the form a
    one-process run saves. Collective over the model groups: every rank
    calls it."""
    out = {}
    for key, model, opt_key, opt in (("gen", state.gen, "opt_g", state.opt_g),
                                     ("disc", state.disc, "opt_d",
                                      state.opt_d)):
        sd = model.state_dict()
        osd = opt.state_dict()
        index = {id(p): i for i, p in enumerate(
            p for g in opt.param_groups for p in g["params"])}
        for name, layer in split_layers(model).items():
            shard = layer.tp_shard
            for pname, pdim in (("weight", shard.dim), ("bias", 0)):
                p = getattr(layer, pname)
                if p is None:
                    continue
                sd[f"{name}.{pname}"] = _gather(p, pdim, shard)
                st = osd["state"].get(index[id(p)])
                if st is not None:
                    osd["state"][index[id(p)]] = {
                        k: (_gather(v, pdim, shard)
                            if torch.is_tensor(v) and v.shape == p.shape
                            else v) for k, v in st.items()}
        out[key], out[opt_key] = sd, osd
    return out
