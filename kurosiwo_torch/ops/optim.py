"""Optimizer factory; counterpart of ``kurosiwo_tpu/ops/optim.py`` for the
segmentation trainer (plain Adam, the reference's
``segmentation_trainer.py:35``).

``torch.optim.Adam`` computes optax.adam's update: bias-corrected moments,
eps outside the square root, no eps_root. The learning rate is set before
each step (``set_learning_rate``), as the JAX step injects it.
"""

from __future__ import annotations

import torch


def create_optimizer(params, config: dict, model_config: dict,
                     task: str = "segmentation") -> torch.optim.Optimizer:
    if task != "segmentation":
        raise NotImplementedError(f"optimizer for task {task!r} is not ported yet (ROADMAP.md, A6-A8)")
    if model_config.get("lr_scales") or config.get("lr_scales"):
        raise NotImplementedError("lr_scales is not ported yet (ROADMAP.md, A8)")
    lr = float(model_config.get("learning_rate", config.get("learning_rate", 1e-3)))
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
