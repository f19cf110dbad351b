"""Learning-rate schedule (``tactile_gan_tpu/train/schedule.py``): x0.8 at
the ten milestones np.int16(np.linspace(epoch_constant, total_epochs,
11)[:-1]), as a function of the optimizer step: during run-epoch
e = (step - step_offset) // steps_per_epoch the rate is
lr * 0.8 ** |{m : m <= e}|. ``step_offset`` restarts the schedule on
--continue_training, as the reference restarts its scheduler.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def milestones(epoch_constant: int, total_epochs: int) -> np.ndarray:
    # The int16 cast is the reference's.
    return np.int16(np.linspace(epoch_constant, total_epochs, 11)[:-1])


def multistep_lr(lr: float, epoch_constant: int, total_epochs: int,
                 steps_per_epoch: int, gamma: float = 0.8,
                 step_offset: int = 0) -> Callable[[int], float]:
    ms = milestones(epoch_constant, total_epochs).astype(np.int64)

    def schedule(step: int) -> float:
        epoch = (step - step_offset) // max(1, steps_per_epoch)
        decays = int(np.sum(epoch >= ms))
        return float(np.float32(lr) * np.float32(gamma) ** np.float32(decays))

    return schedule
