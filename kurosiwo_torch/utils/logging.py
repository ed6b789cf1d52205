"""Metric logging; counterpart of ``kurosiwo_tpu/utils/logging.py``: the
stdout sink (``on_screen_prints``) and the wandb sink (``wandb_activate``),
behind the reference's config keys (segmentation_trainer.py:166-228,
:829-1009). Both sinks are independent, as in the reference. wandb's run id
is kept in ``checkpoint_path/id.json`` (``resume_wandb`` reads it back).
``log_watch`` is ``wandb.watch``'s telemetry: parameter histograms and
per-layer gradient norms under the JAX package's flax-path keys
(``convert.torch_to_flax``'s names and layouts), so that one dashboard
reads both packages. When wandb is requested but not installed, the sink
prints to stdout, as the JAX version does. Under data parallelism only
rank 0 logs to wandb.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..ops.metrics import CLASS_LABELS, NUM_CLASSES


class MetricLogger:
    """``main``: whether this process prints the engine's messages
    (``info``); under data parallelism only rank 0 does, while every rank
    prints the metric lines, which are the global batch's on all of them."""

    def __init__(self, config: dict, main: bool = True):
        self.config = config
        self.main = main
        self.on_screen = bool(config.get("on_screen_prints"))
        self.wandb = None
        if config.get("wandb_activate"):
            try:
                import wandb
            except ImportError:
                print("[kurosiwo_torch] wandb requested but not installed; logging to stdout")
                self.on_screen = True
                return
            if main:
                self.wandb = wandb
                wandb.init(
                    project=config.get("wandb_project"),
                    entity=config.get("wandb_entity"),
                    id=self._run_id(wandb),
                    resume="allow",
                    config={k: v for k, v in config.items()
                            if isinstance(v, (int, float, str, bool))},
                )

    def _run_id(self, wandb) -> str | None:
        """The run id, kept in ``checkpoint_path/id.json`` for resumable runs
        (the reference's change_detection_trainer.py:22-31)."""
        ckpt_path = self.config.get("checkpoint_path")
        if not ckpt_path:
            return None
        id_file = Path(ckpt_path) / "id.json"
        if self.config.get("resume_wandb") and id_file.exists():
            return json.loads(id_file.read_text()).get("run_id")
        run_id = wandb.util.generate_id()
        id_file.parent.mkdir(parents=True, exist_ok=True)
        id_file.write_text(json.dumps({"run_id": run_id}))
        return run_id

    def info(self, msg: str):
        if self.main:
            print(msg, flush=True)

    def log(self, payload: dict):
        """A payload to wandb alone (the engine's images), where it is on."""
        if self.wandb is not None:
            self.wandb.log(payload)

    def _emit(self, payload: dict):
        if self.wandb is not None:
            self.wandb.log(payload)
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

    def log_watch(self, model, grad_norms: dict | None = None, prefix: str = ""):
        """``wandb.watch``'s telemetry (the reference's main.py:144): a
        histogram of every parameter and, with ``grad_norms`` ({parameter
        name: its gradient's norm}), each one's gradient norm, under the
        flax path of the JAX package's ``log_watch`` ("parameters/encoder/
        stem/Conv_0/kernel", "gradients/....norm"), the values in flax's
        layout."""
        if self.wandb is None:
            return
        import numpy as np
        import torch

        from ..convert import torch_to_flax

        names = {n for n, _ in model.named_parameters()}
        params = {k: v for k, v in model.state_dict().items() if k in names}
        flat = _flax_paths(torch_to_flax(params)["params"])
        payload = {f"parameters/{prefix}{path}": self.wandb.Histogram(
            np.asarray(leaf, np.float32).ravel()) for path, leaf in flat.items()}
        if grad_norms is not None:
            names = {k: path for k, path in zip(params, _torch_to_flax_names(params))}
            for name, norm in grad_norms.items():
                value = float(norm.item() if torch.is_tensor(norm) else norm)
                payload[f"gradients/{prefix}{names[name]}.norm"] = value
        self.wandb.log(payload)

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


def _flax_paths(tree: dict, prefix: str = "") -> dict:
    """{"a/b/kernel": leaf} of a nested dict, in the order of jax's
    ``tree_flatten_with_path`` (keys sorted at every level)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flax_paths(v, path + "/"))
        else:
            out[path] = v
    return out


def _torch_to_flax_names(params: dict) -> list[str]:
    """Each parameter name's flax path ("a.b.weight" -> "a/b/kernel")."""
    out = []
    for key in params:
        *path, name = key.split(".")
        out.append("/".join(path + ["kernel" if name == "weight" else name]))
    return out
