"""The process mesh of a parallel run (``tactile_gan_tpu/parallel/mesh.py``).

A run of ``world`` processes (ranks) forms a ``data x model`` grid, as the
JAX package's ``make_mesh`` reshapes its devices: rank r has data index
``r // n_model`` and model index ``r % n_model``. Batches are split over
the data axis (each rank feeds ``local_batch_rows`` of the global batch);
the state is replicated over it, and the step averages every gradient and
the loss vector over the rank's data group (``all_reduce_mean``), as XLA's
psum does. The wide convs are split over the model axis
(``parallel/tensor_parallel.py``); a parameter that is not split is
averaged over the model group as well (``average_gradients``).

Transport: ``nccl`` when every rank has a card of its own, ``gloo`` on the
CPU. Ranks that share one card (``device="cuda:0"``) must ask for ``gloo``:
NCCL refuses two ranks on one device, and this module refuses it first.
Nothing falls back: a partial launch environment, or a failed
``init_process_group``, raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# torchrun's launch environment, all required once any is set.
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")
BACKENDS = ("nccl", "gloo")


def choose_backend(device, backend: Optional[str], ranks_on_host: int
                   ) -> str:
    """The transport for ``ranks_on_host`` ranks on ``device``: the one
    asked for, else nccl on a card and gloo on the CPU. Raises for nccl
    on the CPU, with ranks sharing one card, or with more ranks than
    cards."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"nccl needs a CUDA device, got {str(dev)!r}")
        if dev.index is not None and ranks_on_host > 1:
            raise ValueError(
                f"device {str(dev)!r} is shared by all {ranks_on_host} ranks "
                "of this host, which NCCL refuses; pass device='cuda' (one "
                "card a rank) or backend='gloo'")
        cards = torch.cuda.device_count()
        if ranks_on_host > cards:
            raise ValueError(
                f"NCCL needs one card a rank: {ranks_on_host} ranks on this "
                f"host, {cards} card(s); pass backend='gloo' to share a "
                "card")
    return backend


def rank_device(device, local_rank: int) -> torch.device:
    """``cuda`` without an index is the rank's own card,
    ``cuda:{local_rank}``; any other device is used as given (an indexed
    card is shared by every rank of the host)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank)
    return dev


def ranks_on_host() -> int:
    """The ranks of this process's host: torchrun's LOCAL_WORLD_SIZE, else
    (ranks started by hand on one host) the world size."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def local_rank() -> int:
    """This process's rank on its host: torchrun's LOCAL_RANK, else (ranks
    started by hand on one host) the global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def maybe_init_distributed(device="cuda", backend: Optional[str] = None
                           ) -> bool:
    """Join the process group that torchrun's environment describes.

    No-op (False) when none of ``LAUNCH_ENV`` is set, or when a process
    group already exists (its creator chose the transport). A partial
    environment raises ``ValueError``, as do non-integer ranks: running on
    as independent trainers would have every process write the same
    artifacts. A failed ``init_process_group`` raises."""
    env = {k: os.environ.get(k) for k in LAUNCH_ENV}
    if not any(env.values()):
        return False
    missing = [k for k, v in env.items() if not v]
    if missing:
        given = [k for k in LAUNCH_ENV if k not in missing]
        raise ValueError(
            f"{'/'.join(given)} set but {'/'.join(missing)} not: all of "
            f"{'/'.join(LAUNCH_ENV)} are required for a distributed launch "
            "(torchrun sets them)")
    try:
        rank, world, local = (int(env[k]) for k in
                              ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    except ValueError as e:
        raise ValueError(
            f"RANK={env['RANK']!r} / WORLD_SIZE={env['WORLD_SIZE']!r} / "
            f"LOCAL_RANK={env['LOCAL_RANK']!r} must be integers") from e
    if dist.is_initialized():
        return False
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(device, backend, on_host)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device, local))
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
        f"{env['MASTER_PORT']}", rank=rank, world_size=world)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``n_data x n_model`` grid and the groups it
    talks over: ``data_group`` (the ranks of its model index, which split
    the batch), ``model_group`` (the ranks of its data index, which split
    the wide convs) and ``ckpt_group`` (every rank, gloo: the checkpoint
    writer's collectives run on a thread of their own)."""
    n_data: int
    n_model: int
    rank: int
    backend: str
    data_group: object = None
    model_group: object = None
    ckpt_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}


def grid_groups(n_data: int, n_model: int) -> tuple:
    """(data groups, model groups) as lists of ranks: data group m holds
    the ranks of model index m, model group d those of data index d."""
    data = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]
    model = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    return data, model


def mesh_shape(n_data: int, n_model: int, world: int) -> Tuple[int, int]:
    """(n_data, n_model) of a mesh over ``world`` ranks: ``n_data`` 0 takes
    world // n_model. Raises unless the grid covers the world exactly."""
    if n_model < 1:
        raise ValueError(f"--mesh_model must be >= 1, got {n_model}")
    if n_model > world:
        raise ValueError(f"--mesh_model {n_model} exceeds the world size "
                         f"{world} (launch its ranks with torchrun "
                         "--nproc_per_node)")
    if n_data <= 0:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"--mesh_data {n_data} x --mesh_model {n_model} "
                         f"must equal the world size {world}")
    return n_data, n_model


def make_mesh(n_data: int = 0, n_model: int = 1) -> Mesh:
    """The mesh of the current process group (``mesh_shape``). Collective:
    every rank creates every group, in the same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n_data, n_model = mesh_shape(n_data, n_model, world)
    data, model = grid_groups(n_data, n_model)
    groups = {}
    for kind, lists in (("data", data), ("model", model)):
        for ranks in lists:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[kind] = g
    ckpt = dist.new_group(backend="gloo")
    return Mesh(n_data, n_model, rank, dist.get_backend(),
                groups["data"], groups["model"], ckpt)


def local_batch_rows(global_batch: int, mesh: Mesh) -> slice:
    """The rows ``[d*B/n_data, (d+1)*B/n_data)`` of the global batch that
    the rank of data index d feeds."""
    if global_batch % mesh.n_data:
        raise ValueError(f"global batch {global_batch} must divide evenly "
                         f"over the {mesh.n_data}-wide data axis")
    per = global_batch // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def all_reduce_mean(tensors: Sequence[torch.Tensor], group, n: int
                    ) -> List[torch.Tensor]:
    """Each tensor averaged over the ``n`` ranks of ``group`` (None: every
    rank), through one flattened bucket: a sum, then x 1/n (exact at n
    1)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.mul_(1.0 / n)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def average_gradients(params: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor], mesh: Mesh
                      ) -> List[torch.Tensor]:
    """Each gradient averaged over the ranks that update its parameter: a
    parameter split over the model axis (``tp_shard``) over its data
    group, any other over every rank. The ranks of a model group compute
    the same gradient for a parameter that is not split, but not always
    the same bits: the CPU's threaded kernels sum in an order that varies
    when ranks share the cores (``parallel/rank_probe.py``), and cuDNN
    promises equal bits only from its deterministic algorithms. Averaged,
    the copies stay equal (a no-op in value when the bits agree)."""
    out = list(grads)
    for split, group, n in ((True, mesh.data_group, mesh.n_data),
                            (False, None, mesh.n_data * mesh.n_model)):
        idx = [i for i, p in enumerate(params)
               if (getattr(p, "tp_shard", None) is not None) == split]
        if idx:
            for i, g in zip(idx, all_reduce_mean([grads[i] for i in idx],
                                                 group, n)):
                out[i] = g
    return out
