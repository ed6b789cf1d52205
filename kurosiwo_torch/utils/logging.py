"""Metric logging; counterpart of ``kurosiwo_tpu/utils/logging.py``: the
stdout sink (``on_screen_prints``), behind the reference's config keys
(segmentation_trainer.py:166-228, :829-1009). When wandb is requested but
not installed, the sink prints to stdout, as the JAX version does. The wandb
sink itself (metrics, ``wandb.watch`` histograms, images) is not ported yet
(ROADMAP.md, A14): with wandb installed, ``wandb_activate`` raises.
"""

from __future__ import annotations

import importlib.util
import json

from ..ops.metrics import CLASS_LABELS, NUM_CLASSES


class MetricLogger:
    """``main``: whether this process prints the engine's messages
    (``info``); under data parallelism only rank 0 does, while every rank
    prints the metric lines, which are the global batch's on all of them."""

    def __init__(self, config: dict, main: bool = True):
        self.config = config
        self.main = main
        self.on_screen = bool(config.get("on_screen_prints"))
        if config.get("wandb_activate"):
            if importlib.util.find_spec("wandb") is not None:
                # raised before any wandb call: no remote run, no id.json
                raise NotImplementedError("wandb logging (metrics, watch histograms and images) "
                                          "is not ported yet (ROADMAP.md, A14)")
            print("[kurosiwo_torch] wandb requested but not installed; logging to stdout")
            self.on_screen = True

    def info(self, msg: str):
        if self.main:
            print(msg, flush=True)

    def _emit(self, payload: dict):
        if self.on_screen:
            print(json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                              for k, v in payload.items()}), flush=True)

    def log_train_iteration(self, epoch: int, index: int, loss: float, lr: float,
                            snap: dict | None = None, grad_norm: float | None = None):
        payload = {"Epoch": epoch, "Iteration": index, "Train Loss": loss, "lr": lr}
        if grad_norm is not None:
            # wandb.watch(log_freq=20) equivalent (reference main.py:144)
            payload["Gradient norm"] = grad_norm
        if snap is not None:
            for c in range(NUM_CLASSES):
                payload[f"Train Accuracy ({CLASS_LABELS[c]})"] = 100 * float(snap["accuracy"][c])
                payload[f"Train F-Score ({CLASS_LABELS[c]})"] = 100 * float(snap["fscore"][c])
                payload[f"Train Precision ({CLASS_LABELS[c]})"] = 100 * float(snap["precision"][c])
                payload[f"Train Recall ({CLASS_LABELS[c]})"] = 100 * float(snap["recall"][c])
                payload[f"Train IoU ({CLASS_LABELS[c]})"] = 100 * float(snap["iou"][c])
            payload["Train MeanIoU"] = 100 * snap["mean_iou"]
        self._emit(payload)

    def log_train_epoch(self, epoch: int, summary: dict):
        payload = {"Epoch": epoch, "Train MeanIoU": summary["mean_iou"] * 100}
        for c in range(NUM_CLASSES):
            payload[f"Train F-Score ({CLASS_LABELS[c]})"] = 100 * float(summary["fscore"][c])
            payload[f"Train IoU ({CLASS_LABELS[c]})"] = 100 * float(summary["iou"][c])
        payload["Train epoch time (s)"] = summary.get("epoch_time_s", 0.0)
        self._emit(payload)

    def log_eval(self, settype: str, summary: dict, aoi_summary: dict | None = None):
        payload = {f"{settype} Loss": summary["val_loss"],
                   f"{settype} MeanIoU": 100 * summary["mean_iou"]}
        for c in range(NUM_CLASSES):
            payload[f"{settype} Accuracy ({CLASS_LABELS[c]})"] = 100 * float(summary["accuracy"][c])
            payload[f"{settype} F-Score ({CLASS_LABELS[c]})"] = 100 * float(summary["fscore"][c])
            payload[f"{settype} Precision ({CLASS_LABELS[c]})"] = 100 * float(summary["precision"][c])
            payload[f"{settype} Recall ({CLASS_LABELS[c]})"] = 100 * float(summary["recall"][c])
            payload[f"{settype} IoU ({CLASS_LABELS[c]})"] = 100 * float(summary["iou"][c])
        if self.config.get("evaluate_water") and "water_fscore" in summary:
            payload[f"{settype} F-Score Only Water"] = 100 * float(summary["water_fscore"][1])
        if self.config.get("log_zone_metrics") and "zones" in summary:
            for z, zsum in enumerate(summary["zones"]):
                payload[f"{settype} Zone {z + 1} MeanIoU"] = 100 * zsum["mean_iou"]
        if aoi_summary:
            for act, asum in aoi_summary.items():
                payload[f"{settype} AOI {act} MeanIoU"] = 100 * asum["mean_iou"]
        self._emit(payload)
