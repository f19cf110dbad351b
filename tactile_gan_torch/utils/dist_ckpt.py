"""``--ckpt_backend orbax`` on ``torch.distributed.checkpoint`` (DCP): the
periodic checkpoints of a parallel run (``tactile_gan_tpu/utils/
orbax_ckpt.py``). The flag keeps the JAX package's name, so ``params.txt``
and the CLI stay compatible; the files are DCP's, which the JAX package
does not read (nor the port orbax's: a step directory orbax wrote raises).
The artifact both packages read stays ``final_model.pth``.

- Layout: ``checkpoints/{folder}/orbax/{global_step}/``, numbered by the
  global training step, which becomes the schedule's offset on resume.
- Sharded: every rank writes only what it holds. A tensor split over the
  model axis has a key of its own slice (``...@shard{i}of{n}``); replicated
  tensors share a key, and DCP writes each such key once.
- Async: ``save`` copies the state to the host before it returns (the
  graph replays overwrite the state in place), then writes on a thread of
  its own, over a gloo group of its own (``Mesh.ckpt_group``).
- Complete directories only: DCP writes ``.metadata`` after every rank's
  data, so ``latest_step`` skips a directory without it.
- ``restore`` writes into the live (sharded) state, Adam's moments
  included.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, Optional

import torch

METADATA = ".metadata"
# Entries orbax writes into a step directory.
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")
_ADAM = ("step", "exp_avg", "exp_avg_sq")


def _adam_state(opt: torch.optim.Optimizer, p: torch.Tensor) -> dict:
    """``opt``'s state of ``p``, created as Adam's first step creates it
    where it does not exist yet."""
    st = opt.state.get(p)
    if not st:
        capturable = opt.param_groups[0].get("capturable", False)
        st = opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32,
                                device=p.device if capturable else "cpu"),
            "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
    return st


def flat_state(state) -> Dict[str, torch.Tensor]:
    """The live tensors of a ``TrainState`` by checkpoint key: both
    networks' parameters, their Adam state and the global step."""
    out = {"step": torch.tensor(state.step, dtype=torch.int64)}
    for key, model, opt_key, opt in (("gen", state.gen, "opt_g", state.opt_g),
                                     ("disc", state.disc, "opt_d",
                                      state.opt_d)):
        for name, p in model.named_parameters():
            layer = model.get_submodule(name.rpartition(".")[0])
            shard = getattr(layer, "tp_shard", None)
            sfx = f"@shard{shard.index}of{shard.size}" if shard else ""
            out[f"{key}.{name}{sfx}"] = p.detach()
            st = _adam_state(opt, p)
            for k in _ADAM:
                out[f"{opt_key}.{name}{sfx}.{k}"] = st[k]
    return out


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class DistCheckpointer:
    """Step checkpoints under ``directory``. ``group``: the gloo group of
    every rank, or None in a one-process run. ``save`` and ``restore`` are
    collective: every rank calls them."""

    def __init__(self, directory: str, group=None):
        self.directory = os.path.abspath(directory)
        self.group = group
        self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="dist_ckpt")
        self._pending: Optional[cf.Future] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def latest_step(self) -> Optional[int]:
        """The highest step with a complete checkpoint, or None. A step
        directory that orbax wrote raises ``ValueError``."""
        if not os.path.isdir(self.directory):
            return None
        steps = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if not (name.isdigit() and os.path.isdir(path)):
                continue
            if os.path.exists(os.path.join(path, METADATA)):
                steps.append(int(name))
            elif any(os.path.exists(os.path.join(path, m))
                     for m in ORBAX_MARKERS):
                raise ValueError(
                    f"{path} was written by orbax (the JAX package's "
                    "--ckpt_backend orbax), not readable by the port; "
                    "resume from final_model.pth, which both packages read")
        return max(steps, default=None)

    def save(self, step: int, state) -> None:
        """Copy ``state`` to the host, then write it as step ``step`` on
        the writer thread (one save in flight)."""
        self.wait()
        staged = _to_host(flat_state(state))
        self._pending = self._pool.submit(self._write, self._path(step),
                                          staged)

    def _write(self, path: str, staged: Dict[str, torch.Tensor]) -> None:
        import torch.distributed.checkpoint as dcp

        dcp.save(staged, storage_writer=dcp.FileSystemWriter(path),
                 process_group=self.group, no_dist=self.group is None)

    def restore(self, step: int, state) -> None:
        """Read step ``step`` into ``state``'s live tensors and set its
        step."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        live = flat_state(state)
        staged = _to_host(live)
        dcp.load(staged, storage_reader=dcp.FileSystemReader(self._path(step)),
                 process_group=self.group, no_dist=self.group is None)
        with torch.no_grad():
            for k, v in live.items():
                v.copy_(staged[k])
        state.step = int(staged["step"])

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
