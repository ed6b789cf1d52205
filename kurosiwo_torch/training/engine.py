"""The epoch-loop engine of the segmentation task; counterpart of
``kurosiwo_tpu/training/engine.py``.

One train step and one eval step (``steps.py``); per epoch: train, evaluate
on val, keep ``best_segmentation`` (val mIoU) and ``latest``, then reload
best for the final test eval. The metric banks stay on the card inside an
epoch: the host reads them at ``print_frequency`` and at the end of an epoch,
and nowhere else in the train loop.

Batches reach the card through :func:`device_prefetch`: pinned host buffers
and a copy stream, so the upload of batch k+1 overlaps the step of batch k.

Change detection (A6) and the recurrent task (A7) are not ported; nor are
pretrained weights (A13), wandb logging and visualizations (A14).
"""

from __future__ import annotations

import collections
import time
import warnings

import numpy as np
import torch

from ..data.pipeline import Loader
from ..device import configure_backends, resolve_device
from ..ops.losses import create_loss
from ..ops.metrics import HostAOIMetrics, MetricState, derive
from ..ops.schedules import create_lr_schedule
from ..utils.logging import MetricLogger
from .checkpoint import CheckpointManager
from .state import create_train_state
from .steps import STEP_KEYS, make_eval_step, make_train_step


def device_prefetch(loader, device: str | torch.device, depth: int = 2):
    """Iterate ``loader``'s batches with their ``STEP_KEYS`` on the card,
    ``depth`` batches in flight: each is copied into one of ``depth`` pinned
    host slots and uploaded on a copy stream, and the compute stream waits
    on that copy's event before it uses the batch. A slot is refilled only
    after its previous upload has finished (the host waits on the copy's
    event, not on the compute stream). The other keys (``activation``,
    ``clz``, ``valid``, ...) stay on the host as numpy arrays. On the CPU the
    batches pass through unchanged."""
    dev = torch.device(device)
    if dev.type != "cuda":
        yield from loader
        return
    copy_stream = torch.cuda.Stream(dev)
    slots = [{"buffers": {}, "event": None} for _ in range(depth)]
    inflight: collections.deque = collections.deque()

    def upload(slot: dict, host: dict):
        if slot["event"] is not None:
            slot["event"].synchronize()  # the slot's previous upload has read it
        out, uploaded = dict(host), []
        with torch.cuda.stream(copy_stream):
            for k in STEP_KEYS:
                if k not in host:
                    continue
                src = torch.from_numpy(np.ascontiguousarray(host[k]))
                buf = slot["buffers"].get(k)
                if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                    buf = slot["buffers"][k] = torch.empty(src.shape, dtype=src.dtype,
                                                           pin_memory=True)
                buf.copy_(src)
                out[k] = buf.to(dev, non_blocking=True)
                uploaded.append(out[k])
            slot["event"] = torch.cuda.Event()
            slot["event"].record(copy_stream)
        return out, uploaded, slot

    it = iter(loader)
    for slot in slots:
        host = next(it, None)
        if host is None:
            break
        inflight.append(upload(slot, host))
    while inflight:
        out, uploaded, slot = inflight.popleft()
        compute = torch.cuda.current_stream(dev)
        compute.wait_event(slot["event"])
        for t in uploaded:
            # allocated on the copy stream: keep the allocator from handing
            # the memory out again while the compute stream may still use it
            t.record_stream(compute)
        yield out
        host = next(it, None)
        if host is not None:
            inflight.append(upload(slot, host))


class TaskEngine:
    """Owns the model's train state and its two steps for one task."""

    def __init__(self, model: torch.nn.Module, config: dict, model_config: dict, task: str,
                 steps_per_epoch: int, device: str | torch.device | None = "cuda"):
        if task != "segmentation":
            raise NotImplementedError(f"the {task!r} engine is not ported yet (ROADMAP.md, A6-A7)")
        self.device = resolve_device(device)
        configure_backends()
        self.model = model
        self.config = config
        self.model_config = model_config
        self.task = task
        if config.get("save_visualizations"):
            raise NotImplementedError("visualizations (save_visualizations; utils/visualize.py) "
                                      "are not ported yet (ROADMAP.md, A14)")
        self.logger = MetricLogger(config)  # raises on wandb_activate with wandb installed (A14)
        self.state = create_train_state(model, config, model_config, task)
        self.lr_schedule = create_lr_schedule(config, model_config, steps_per_epoch)
        self._check_pretrained_weights()

        self.with_aoi = bool(config.get("log_AOI_metrics"))
        # wandb.watch-equivalent gradient tracking (reference main.py:144)
        self.with_grad_norm = bool(config.get("wandb_activate") or config.get("log_grad_norm"))
        self._train_step = make_train_step(
            model, create_loss(config, "train"), config, model_config, task, self.device,
            with_grad_norm=self.with_grad_norm)
        # eval in f32 like the reference (autocast off at eval,
        # segmentation_trainer.py:321): the same f32 parameters, f32 compute;
        # f32_eval: false evaluates under the bf16 policy
        eval_dtype = None
        if config.get("f32_eval", True) and getattr(model, "dtype", None) == torch.bfloat16:
            eval_dtype = torch.float32
        self._eval_step = make_eval_step(
            model, create_loss(config, "val"), config, model_config, task, self.device,
            dtype=eval_dtype, with_aoi=self.with_aoi)

    def _check_pretrained_weights(self) -> None:
        cfg = self.config
        for key in ("pretrained_checkpoint", "pretrained_encoder", "pretrained_upernet"):
            if cfg.get(key):
                raise NotImplementedError(f"{key} (weights from the reference's torch files) is "
                                          "not ported yet (ROADMAP.md, A13)")
        if cfg.get("pretrained") or cfg.get("encoder_weights"):
            # the reference defaults these methods to ImageNet-pretrained
            # encoders (model_utilities.py:110-157); make the gap loud
            warnings.warn(
                f"config requests pretrained weights (pretrained={cfg.get('pretrained')!r}, "
                f"encoder_weights={cfg.get('encoder_weights')!r}) for method "
                f"{cfg.get('method')!r} but no weight source is set — training starts from "
                "RANDOM init, unlike the reference default. Loading pretrained weights is "
                "not ported yet (ROADMAP.md, A13).",
                stacklevel=2,
            )

    def run_train_epoch(self, loader: Loader, epoch: int) -> dict:
        """One epoch of train steps at the epoch's learning rate. The summary
        adds ``epoch_time_s`` (host clock, the banks read at the end),
        ``data_wait_s`` (host time spent waiting for the next batch) and
        ``batches``."""
        metric_state = MetricState.create(self.device)
        lr_value = float(self.lr_schedule(epoch))
        print_every = int(self.config.get("print_frequency", 10))
        t0 = time.perf_counter()
        wait = 0.0
        nbatches = 0
        batches = device_prefetch(loader, self.device)
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t
            if batch is None:
                break
            self.state, metric_state, aux = self._train_step(self.state, batch, metric_state,
                                                             lr_value)
            loss, grad_norm = aux if self.with_grad_norm else (aux, None)
            if nbatches % print_every == 0:
                self.logger.log_train_iteration(
                    epoch, nbatches, float(loss), lr_value, derive(metric_state.cm.cpu().numpy()),
                    grad_norm=None if grad_norm is None else float(grad_norm))
            nbatches += 1
        summary = metric_state.summarize()
        summary["epoch_time_s"] = time.perf_counter() - t0
        summary["data_wait_s"] = wait
        summary["batches"] = nbatches
        summary["mean_loss"] = float(summary["val_loss"])
        return summary

    def run_eval(self, loader: Loader, settype: str = "Val") -> tuple[float, float, float, dict]:
        """(100·acc, 100·meanF1, 100·mIoU, summary); with ``log_AOI_metrics``
        the summary's ``aoi_banks`` holds the per-activation banks."""
        metric_state = MetricState.create(self.device)
        per_sample, activations = [], []
        for batch in device_prefetch(loader, self.device):
            metric_state, _, aux = self._eval_step(self.state, batch, metric_state)
            if self.with_aoi:
                per_sample.append(aux["per_sample_cm"])
                activations.append(np.asarray(batch["activation"]))
        summary = metric_state.summarize()
        aoi_summary = None
        if self.with_aoi:
            aoi = HostAOIMetrics()
            if per_sample:  # one read of the epoch's per-sample matrices
                aoi.update(torch.cat(per_sample).cpu().numpy(), np.concatenate(activations))
            summary["aoi_banks"] = aoi.banks
            aoi_summary = aoi.summarize()
        self.logger.log_eval(settype, summary, aoi_summary)
        return (100.0 * summary["micro_accuracy"], 100.0 * summary["mean_f1"],
                100.0 * summary["mean_iou"], summary)


def train_task(model: torch.nn.Module, train_loader: Loader, val_loader: Loader,
               test_loader: Loader, config: dict, model_config: dict, task: str,
               device: str | torch.device | None = "cuda") -> TaskEngine:
    """The training loop: epochs -> val -> best-mIoU checkpoint, then the
    best weights reloaded for the final test eval (reference main.py:151-158).
    ``test_loader`` is the caller's to evaluate."""
    del test_loader
    engine = TaskEngine(model, config, model_config, task, steps_per_epoch=len(train_loader),
                        device=device)
    ckpt = CheckpointManager(config.get("checkpoint_path", "checkpoints/run"), engine.device)
    start_epoch = int(config.get("start_epoch", 0))
    best_val = 0.0
    if config.get("resume_checkpoint"):
        # preemption-safe resume: the rolling "latest" (epoch and best
        # metric) first, else best_segmentation (utilities/utilities.py:300-303)
        if ckpt.has("latest"):
            engine.state, extra = ckpt.restore("latest", engine.state)
            start_epoch = int(extra.get("epoch", -1)) + 1
            best_val = float(extra.get("best_val", 0.0))
            engine.logger.info(f"Resumed from latest checkpoint at epoch {start_epoch}")
        elif ckpt.has("best_segmentation"):
            engine.state, extra = ckpt.restore("best_segmentation", engine.state)
            # keep its metric, so a worse epoch cannot replace a better best
            best_val = float(extra.get("metric", 0.0))
            engine.logger.info(f"Resumed from best_segmentation (val mIoU {best_val:.3f})")

    for epoch in range(start_epoch, int(config.get("epochs", 1))):
        engine.logger.log_train_epoch(epoch, engine.run_train_epoch(train_loader, epoch))
        _, _, miou, _ = engine.run_eval(val_loader, "Val")
        if miou > best_val:
            best_val = miou
            engine.logger.info(f"Epoch {epoch}: new best validation mIoU {miou:.3f}")
            ckpt.save_best(engine.state, epoch, miou)
        ckpt.save("latest", engine.state, extra={"epoch": epoch, "best_val": best_val})
    if ckpt.has("best_segmentation"):
        engine.state, _ = ckpt.restore("best_segmentation", engine.state)
        engine.logger.info("Restored best_segmentation for the final test eval")
    return engine


def evaluate_task(model: torch.nn.Module, config: dict, model_config: dict, task: str,
                  device: str | torch.device | None = "cuda") -> TaskEngine:
    """Eval-only engine (the reference's ``"test": true``, main.py:86-128):
    restore best_segmentation and skip training. Raises when there is none,
    rather than scoring a random-init model."""
    engine = TaskEngine(model, config, model_config, task, steps_per_epoch=1, device=device)
    ckpt = CheckpointManager(config.get("checkpoint_path", "checkpoints/run"), engine.device)
    if not ckpt.has("best_segmentation"):
        raise FileNotFoundError(
            f"\"test\": true but no best_segmentation checkpoint in {ckpt.dir}")
    engine.state, extra = ckpt.restore("best_segmentation", engine.state)
    engine.logger.info(f"Eval-only: restored best_segmentation (val mIoU "
                       f"{float(extra.get('metric', float('nan'))):.3f})")
    return engine
