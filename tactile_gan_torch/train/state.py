"""Training state: both networks, their Adam optimizers and the step count
(``tactile_gan_tpu/train/state.py``). Adam follows the reference:
betas (beta1, 0.99), eps 1e-8. The learning rate is set from the schedule
before every update, as optax evaluates it at the update count.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch
from torch import nn


def make_optimizer(params: Iterable[torch.Tensor], lr: float,
                   beta1: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.99), eps=1e-8)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


@dataclasses.dataclass
class TrainState:
    gen: nn.Module
    disc: nn.Module
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0
