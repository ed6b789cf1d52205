"""Metric bank as a confusion matrix; counterpart of
``kurosiwo_tpu/ops/metrics.py`` (own copies of ``derive`` and
``collapse_water_cm``). The bank stays on the device during training and is
read on the host only by ``summarize``. Per-AOI banks live on the host
(``HostAOIMetrics``), fed by the eval step's per-sample matrices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

IGNORE_INDEX = 3
NUM_CLASSES = 3  # semantic classes; the bank is (C+1)x(C+1) like the reference
CLASS_LABELS = {0: "No water", 1: "Water", 2: "Flood", 3: "Invalid"}


def confusion_matrix(predictions: torch.Tensor, labels: torch.Tensor,
                     num_classes: int = NUM_CLASSES + 1,
                     ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts cm[label, pred] over pixels
    whose label is not ``ignore_index``."""
    preds = predictions.reshape(-1).long()
    labs = labels.reshape(-1).long()
    n2 = num_classes * num_classes
    cell = torch.where(labs != ignore_index, labs * num_classes + preds, n2)
    return torch.bincount(cell, minlength=n2 + 1)[:n2].reshape(num_classes, num_classes)


def per_sample_confusion(predictions: torch.Tensor, labels: torch.Tensor,
                         num_classes: int = NUM_CLASSES + 1,
                         ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """(B, C, C) int64 confusion matrices, one per sample, as one batched
    bincount (``confusion_matrix`` of each sample)."""
    b = predictions.shape[0]
    preds = predictions.reshape(b, -1).long()
    labs = labels.reshape(b, -1).long()
    n2 = num_classes * num_classes
    rows = torch.arange(b, device=preds.device)[:, None] * n2
    cell = torch.where(labs != ignore_index, rows + labs * num_classes + preds, b * n2)
    counts = torch.bincount(cell.reshape(-1), minlength=b * n2 + 1)
    return counts[:b * n2].reshape(b, num_classes, num_classes)


_WATER_GROUP = np.asarray([0, 1, 1, 3])  # class collapse {1,2} -> 1


def collapse_water_cm(cm: np.ndarray) -> np.ndarray:
    """The binary water bank (classes {1,2} -> 1) as a regrouping of the cm."""
    out = np.zeros_like(cm)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            out[_WATER_GROUP[i], _WATER_GROUP[j]] += cm[i, j]
    return out


def derive(cm) -> dict[str, Any]:
    """All reference-visible metrics from a confusion matrix (torchmetrics
    ``average="none"`` semantics: per-class accuracy equals recall)."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    support = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    union = support + predicted - tp

    def safe(n, d):
        return np.where(d > 0, n / np.where(d > 0, d, 1.0), 0.0)

    recall = safe(tp, support)
    precision = safe(tp, predicted)
    f1 = safe(2 * precision * recall, precision + recall)
    iou = safe(tp, union)
    total = cm.sum()
    micro_acc = tp.sum() / max(total, 1.0)
    return {
        "accuracy": recall,
        "precision": precision,
        "recall": recall,
        "fscore": f1,
        "iou": iou,
        "micro_accuracy": micro_acc,
        "mean_iou": float(iou[:NUM_CLASSES].mean()),
        "mean_f1": float(f1[:NUM_CLASSES].mean()),
        "support": support,
    }


@dataclasses.dataclass
class MetricState:
    """Device-resident accumulator: f32 cm bank (exact below 2^24 per
    update) and running weighted loss. Updates return a new state, like the
    JAX pytree. The per-zone banks of the JAX state come with
    ``log_zone_metrics`` (ROADMAP.md, A1)."""

    cm: torch.Tensor
    loss_sum: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def create(device: torch.device | str = "cpu",
               num_classes: int = NUM_CLASSES + 1) -> "MetricState":
        f = dict(dtype=torch.float32, device=device)
        return MetricState(
            cm=torch.zeros((num_classes, num_classes), **f),
            loss_sum=torch.zeros((), **f),
            count=torch.zeros((), **f),
        )

    def update(self, predictions, labels, loss, batch_weight=1.0) -> "MetricState":
        cm = confusion_matrix(predictions, labels).float()
        return self.update_from_cm(cm, loss, batch_weight)

    def update_from_cm(self, cm, loss, batch_weight=1.0) -> "MetricState":
        """Accumulate a precomputed (C, C) confusion matrix (e.g. from the
        fused tail, ops/fused_tail.py)."""
        loss = loss.detach().float()
        return MetricState(
            cm=self.cm + cm.float(),
            loss_sum=self.loss_sum + loss * batch_weight,
            count=self.count + batch_weight,
        )

    def summarize(self) -> dict[str, Any]:
        cm = self.cm.cpu().numpy()
        out = derive(cm)
        out["cm"] = cm
        out["water_fscore"] = derive(collapse_water_cm(cm))["fscore"]
        out["val_loss"] = float(self.loss_sum) / max(float(self.count), 1e-12)
        return out


class HostAOIMetrics:
    """Per-AOI metric banks (reference: segmentation_trainer.py:293-308).
    Activation ids are arbitrary ints, so the banks are a host dict fed by
    the eval step's per-sample confusion matrices."""

    def __init__(self):
        self.banks: dict[int, np.ndarray] = {}

    def update(self, per_sample_cm: np.ndarray, activations: np.ndarray) -> None:
        for cm_i, act in zip(per_sample_cm, activations):
            a = int(act)
            if a not in self.banks:
                self.banks[a] = np.zeros_like(cm_i, dtype=np.int64)
            self.banks[a] += cm_i.astype(np.int64)

    def summarize(self) -> dict[int, dict[str, Any]]:
        return {a: derive(cm) for a, cm in sorted(self.banks.items())}
