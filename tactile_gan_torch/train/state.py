"""Training state: both networks, their Adam optimizers and the step count
(``tactile_gan_tpu/train/state.py``). Adam follows the reference:
betas (beta1, 0.99), eps 1e-8. The learning rate is set from the schedule
before every update, as optax evaluates it at the update count.

On the card Adam is built for CUDA-graph capture: ``capturable=True`` (its
step counts and bias corrections stay on the device) and the learning rate
a 0-dim float32 tensor on the device, which ``set_lr`` fills in place. A
captured step keeps reading the tensor it captured, so the rate is never
replaced by a new object once an optimizer exists. On the CPU Adam takes a
Python float, as before.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import torch
from torch import nn


def make_optimizer(params: Iterable[torch.Tensor], lr: float,
                   beta1: float) -> torch.optim.Adam:
    """Adam over ``params``; capturable, with a device learning rate, when
    they lie on a CUDA device."""
    params = list(params)
    kw = dict(betas=(beta1, 0.99), eps=1e-8)
    if params and params[0].is_cuda:
        rate = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
        return torch.optim.Adam(params, lr=rate, capturable=True, **kw)
    return torch.optim.Adam(params, lr=lr, **kw)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's rate: a tensor rate is filled in place (a graph
    that captured it reads the new value), a float one is replaced."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(opt: torch.optim.Optimizer, saved: Mapping) -> None:
    """Load a torch optimizer ``state_dict`` into ``opt``, keeping ``opt``'s
    own group settings: its rate object (the schedule sets the value) and
    ``capturable``, so that a checkpoint written on one device resumes on
    the other (torch places a capturable optimizer's step counts on the
    parameters' device)."""
    rates = [g["lr"] for g in opt.param_groups]
    groups = [{**{k: v for k, v in ours.items() if k != "params"},
               "params": theirs["params"]}
              for ours, theirs in zip(opt.param_groups,
                                      saved["param_groups"])]
    opt.load_state_dict({"state": saved["state"], "param_groups": groups})
    for group, rate in zip(opt.param_groups, rates):
        group["lr"] = rate  # load_state_dict deep-copies the groups


@dataclasses.dataclass
class TrainState:
    gen: nn.Module
    disc: nn.Module
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0
