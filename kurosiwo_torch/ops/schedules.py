"""Learning-rate schedules the port's trainers use; the port's own copy of
``kurosiwo_tpu/ops/schedules.py`` (host-side plain math). The epoch-level
schedules are functions of the epoch index, stepped once an epoch like the
reference's schedulers (``utilities/utilities.py:268-304``)."""

from __future__ import annotations

import math
from typing import Callable


def cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0) -> Callable:
    """torch CosineAnnealingLR: lr(e) = eta_min + (base-eta_min)*(1+cos(pi*e/T))/2."""

    def schedule(epoch):
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * float(epoch) / t_max)) / 2

    return schedule


def linear_decay(base_lr: float, epochs: int) -> Callable:
    """Reference 'linear': lr(e) = base * (1 - e / (epochs + 1))."""

    def schedule(epoch):
        return base_lr * (1.0 - epoch / float(epochs + 1))

    return schedule


def step_decay(base_lr: float, epochs: int, gamma: float = 0.1) -> Callable:
    """StepLR with step_size=epochs//3 (the reference's 'step' branch names
    an undefined scheduler, utilities/utilities.py:293; this is its intent)."""
    step_size = max(epochs // 3, 1)

    def schedule(epoch):
        return base_lr * (gamma ** (epoch // step_size))

    return schedule


def constant(base_lr: float) -> Callable:
    def schedule(epoch):
        del epoch
        return float(base_lr)

    return schedule


def mae_warmup_cosine(base_lr: float, min_lr: float, warmup_epochs: float,
                      total_epochs: float) -> Callable:
    """Per-iteration linear warmup then half-cycle cosine (the reference's
    ``train_mae.py:14-32``). The argument is a fractional epoch
    (epoch + iter / steps_per_epoch)."""

    def schedule(frac_epoch):
        frac_epoch = float(frac_epoch)
        if frac_epoch < warmup_epochs:
            return base_lr * frac_epoch / max(warmup_epochs, 1e-12)
        denom = max(total_epochs - warmup_epochs, 1e-12)
        return min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * (frac_epoch - warmup_epochs) / denom))

    return schedule


def create_lr_schedule(config: dict, model_config: dict, steps_per_epoch: int) -> Callable:
    """The reference's init_lr_scheduler selection; returns lr(epoch)."""
    name = model_config.get("lr_schedule")
    base_lr = float(model_config.get("learning_rate", config.get("learning_rate", 1e-3)))
    if name == "cosine":
        # the reference builds CosineAnnealingLR with T_max = len(train_loader)
        # and steps it once an epoch; kept as it is
        return cosine_annealing(base_lr, max(steps_per_epoch, 1))
    if name is None:
        return constant(base_lr)
    if name == "linear":
        return linear_decay(base_lr, int(config.get("epochs", 1)))
    if name == "step":
        return step_decay(base_lr, int(config.get("epochs", 1)))
    raise NotImplementedError(f"{name} LR scheduling is not implemented")
