"""Segmentation losses; counterpart of ``kurosiwo_tpu/ops/losses.py``, with
the same names and the same selection (``create_loss``):

  cross_entropy  weighted CE, ignore_index=3 (train weighted, val unweighted)
  dice           smp.DiceLoss(mode="multiclass", ignore_index=3) semantics
  focal          multi-class focal loss, alpha = class_weights, gamma = 2
  iou            Lovasz-softmax, multiclass, ignore_index=3
  ce+dice        weighted CE + soft dice (torchgeometry form)

Logits are (B, H, W, C), labels (B, H, W) with values in {0, 1, 2, 3},
3 = ignore. Every loss is computed in f32 from upcast (bf16) logits;
autograd gives the backward. The focal loss's alpha and gamma come from the
class weights and 2.0, as the JAX package builds it; no config file is read.

Under data parallelism (``parallel/mesh.use_grid``) every loss is the global
batch's, as the JAX step computes it over the sharded batch: each reduction
over the batch is summed over the data group (``global_sum``, whose backward
hands each rank the gradient of its own term), so every rank gets the same
loss and the ranks' parameter gradients sum to the global batch's. The
Lovasz loss sorts the errors of the whole batch: the ranks' errors and
labels are gathered, every rank computes the global Lovasz weights in the
single-process order (the rank blocks are contiguous rows of the batch), and
each rank's gradient flows through its own pixels' errors times their
weights.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ..parallel.mesh import gather_rows, global_mean, global_rows, global_sum

IGNORE_INDEX = 3


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot of ``labels``; a label outside [0, C) (the ignore index)
    gives an all-zero row, as ``jax.nn.one_hot``."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long()[..., None] == classes).float()


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
    one_hot = _one_hot(labels, num_classes)  # a one-hot product, not a gather: no
    picked = (log_probs * one_hot).sum(dim=-1)  # scatter in the backward
    w = (one_hot * cw).sum(dim=-1)
    total_w = torch.clamp_min(global_sum(w.sum()), 1e-12)
    return -global_sum((picked * w).sum()) / total_w


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              ignore_index: int | None = IGNORE_INDEX, use_softmax: bool = True,
              eps: float = 1e-6) -> torch.Tensor:
    """Soft dice of the reference's ce+dice (utilities/dice.py:92-137):
    ignored pixels are relabelled as class 0 in the one-hot (not dropped),
    eps is added to every one-hot entry, and the score is taken over
    (H, W, C) per sample, then averaged over the batch."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1) if use_softmax else logits.float()
    masked = labels if ignore_index is None else torch.where(labels == ignore_index, 0, labels)
    one_hot = _one_hot(masked, num_classes) + eps
    dims = tuple(range(1, probs.ndim))
    intersection = (probs * one_hot).sum(dim=dims)
    cardinality = (probs + one_hot).sum(dim=dims)
    return global_mean(1.0 - 2.0 * intersection / (cardinality + eps))


def smp_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = IGNORE_INDEX, eps: float = 1e-7) -> torch.Tensor:
    """smp.losses.DiceLoss(mode="multiclass", ignore_index=3), the "dice"
    loss: ignored pixels are masked out of prediction and one-hot, the score
    is per class over batch and space, and classes absent from the batch
    count 0 in the class mean."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    valid = (labels != ignore_index)[..., None].float()
    one_hot = _one_hot(labels, num_classes) * valid
    probs = probs * valid
    dims = tuple(range(probs.ndim - 1))
    intersection = global_sum((probs * one_hot).sum(dim=dims))
    cardinality = global_sum((probs + one_hot).sum(dim=dims))
    loss = 1.0 - 2.0 * intersection / torch.clamp_min(cardinality, eps)
    present = (global_sum(one_hot.sum(dim=dims)) > 0).float()
    return (loss * present).mean()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha=None, gamma: float = 2.0,
               ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Multi-class focal loss, -alpha_t (1 - p_t)^gamma log p_t, the mean over
    valid pixels (the torch.hub 'adeelh' focal loss the reference loads)."""
    num_classes = logits.shape[-1]
    if ignore_index < num_classes:
        raise ValueError(f"ignore_index {ignore_index} must be >= num_classes {num_classes}")
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    one_hot = _one_hot(labels, num_classes)
    log_pt = (log_probs * one_hot).sum(dim=-1)
    focal = -((1.0 - torch.exp(log_pt)) ** gamma) * log_pt
    if alpha is not None:
        a = torch.as_tensor(alpha, dtype=torch.float32, device=logits.device)
        focal = focal * (one_hot * a).sum(dim=-1)
    valid = one_hot.sum(dim=-1)
    return global_sum((focal * valid).sum()) / torch.clamp_min(global_sum(valid.sum()), 1e-12)


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension with respect to the sorted 0/1
    labels' errors, one row per class. The running counts are integer
    cumsums (exact, as f32's are below 2^24, and deterministic on the card,
    where a float cumsum is not)."""
    fg = gt_sorted.to(torch.int64)
    gts = fg.sum(dim=-1, keepdim=True)
    intersection = (gts - fg.cumsum(dim=-1)).float()
    union = (gts + (1 - fg).cumsum(dim=-1)).float()
    jaccard = 1.0 - intersection / torch.clamp_min(union, 1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


def lovasz_softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                        ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Lovasz-softmax over the whole batch, present classes only (smp's
    LovaszLoss(mode="multiclass", ignore_index=3)). Ignored pixels get error
    -1, so a stable descending sort puts them last, in index order, where
    their terms are zero; the order of tied errors is that of JAX's
    ``argsort(-errors)``."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, num_classes).t()  # (C, N)
    flat = labels.reshape(-1)
    valid = flat != ignore_index
    classes = torch.arange(num_classes, device=logits.device)[:, None]
    fg = torch.where(valid, (flat == classes).float(), 0.0)
    errors = torch.where(valid, (fg - probs).abs(), -1.0)
    with torch.no_grad():
        # the whole batch's errors and labels (this rank's alone outside data
        # parallelism), in the batch's pixel order
        all_fg = gather_rows(fg, dim=1)
        order = torch.sort(-gather_rows(errors.detach(), dim=1), dim=-1, stable=True).indices
        # the Lovasz gradient of each sorted position, put back at the
        # pixel it came from: the loss is then a product with the unsorted
        # errors, whose backward needs no scatter
        grad = _lovasz_grad(all_fg.gather(-1, order))
        weight = grad.gather(-1, torch.argsort(order, dim=-1))[:, global_rows(flat.numel())[1]]
    losses = global_sum((torch.where(valid, errors, 0.0) * weight).sum(dim=-1))
    present = (all_fg.sum(dim=-1) > 0).float()
    return (losses * present).sum() / torch.clamp_min(present.sum(), 1.0)


def ce_and_dice_loss(logits: torch.Tensor, labels: torch.Tensor, class_weights=None,
                     ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """The reference's BCEandDiceLoss (utilities/bce_and_dice.py:7-23):
    weighted CE plus the softmax dice, summed."""
    return (cross_entropy_loss(logits, labels, class_weights, ignore_index)
            + dice_loss(logits, labels, ignore_index, use_softmax=True))


def create_loss(config: dict, mode: str = "val") -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The reference's loss selection (utilities/utilities.py:307-347):
    ``mode="train"`` applies the class weights to cross entropy, and eval
    uses unweighted cross entropy; the other losses are the same in both."""
    name = config.get("loss_function", "cross_entropy")
    weights = config.get("class_weights", [1.0, 1.0, 1.0])
    if name == "cross_entropy":
        return functools.partial(cross_entropy_loss,
                                 class_weights=weights if mode == "train" else None)
    if name == "iou":
        return lovasz_softmax_loss
    if name == "dice":
        return smp_dice_loss
    if name == "focal":
        return functools.partial(focal_loss, alpha=weights, gamma=2.0)
    if name == "ce+dice":
        return functools.partial(ce_and_dice_loss, class_weights=weights)
    raise NotImplementedError(f"loss {name!r} is not supported")
