"""Learning-rate schedules the port's trainers use; the port's own copy of
``kurosiwo_tpu/ops/schedules.py`` (host-side plain math, step -> lr)."""

from __future__ import annotations

import math
from typing import Callable


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
