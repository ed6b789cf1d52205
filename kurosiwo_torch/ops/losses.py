"""Segmentation losses; counterpart of ``kurosiwo_tpu/ops/losses.py`` for the
cross entropy the UNet step uses (the eval criterion, and the train tail
when ``fused_tail`` is false).

Logits are (B, H, W, C), labels (B, H, W) with values in {0, 1, 2, 3},
3 = ignore.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

IGNORE_INDEX = 3


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights=None, ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Weighted softmax cross entropy with ignore_index, mean-reduced like
    torch.nn.CrossEntropyLoss(weight=w, ignore_index=3): the denominator is
    the sum of the weights of the valid targets, clamped at 1e-12. Computed
    in f32 on upcast logits; autograd gives the backward."""
    num_classes = logits.shape[-1]
    if ignore_index < num_classes:
        raise ValueError(f"ignore_index {ignore_index} must be >= num_classes {num_classes}")
    if class_weights is None:
        cw = torch.ones(num_classes, dtype=torch.float32, device=logits.device)
    else:
        cw = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    lab = labels.long()
    valid = (lab >= 0) & (lab < num_classes)
    safe = torch.where(valid, lab, 0)
    picked = log_probs.gather(-1, safe[..., None])[..., 0]
    w = torch.where(valid, cw[safe], 0.0)
    total_w = torch.clamp_min(w.sum(), 1e-12)
    return -(picked * w).sum() / total_w


def create_loss(config: dict, mode: str = "val") -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The reference's loss selection: ``mode="train"`` applies the class
    weights to cross entropy; eval uses unweighted cross entropy."""
    name = config.get("loss_function", "cross_entropy")
    if name == "cross_entropy":
        cw = config.get("class_weights", [1.0, 1.0, 1.0]) if mode == "train" else None
        return functools.partial(cross_entropy_loss, class_weights=cw)
    if name in ("iou", "dice", "focal", "ce+dice"):
        raise NotImplementedError(f"loss {name!r} is not ported yet (ROADMAP.md, A1)")
    raise NotImplementedError(f"loss {name!r} is not supported")
