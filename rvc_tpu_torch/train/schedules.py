"""Learning-rate schedule (port of ``rvc_tpu/train/schedules.py``).

An optional per-epoch linear warmup ((epoch + 1) / warmup) followed by a
per-epoch exponential decay by ``gamma`` (0.999875). The schedule is a
function of the optimizer's step count, the epoch being step //
steps_per_epoch, so an optimizer that asks it once per step follows the
reference's once-per-epoch scheduler steps.
"""

from __future__ import annotations

from typing import Callable


def make_epoch_lr_schedule(base_lr: float, steps_per_epoch: int,
                           warmup_epochs: int = 0,
                           gamma: float = 0.999875) -> Callable[[int], float]:
    """step -> learning rate: (e + 1) / warmup for the epochs e < warmup,
    then gamma^(e + 1 - warmup) (gamma^e without warmup)."""
    spe = max(1, int(steps_per_epoch))

    def schedule(step: int) -> float:
        epoch = int(step) // spe
        if warmup_epochs > 0:
            warm = min((epoch + 1) / warmup_epochs, 1.0)
            decay_epochs = max(epoch + 1 - warmup_epochs, 0)
        else:
            warm, decay_epochs = 1.0, epoch
        return base_lr * warm * gamma ** decay_epochs

    return schedule
