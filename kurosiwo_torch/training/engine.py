"""The epoch-loop engine of the segmentation, change-detection and
recurrent tasks; counterpart of ``kurosiwo_tpu/training/engine.py``.

One train step and one eval step (``steps.py``); per epoch: train, evaluate
on val, keep ``best_segmentation`` (val mIoU) and ``latest``, then reload
best for the final test eval. The metric banks stay on the card inside an
epoch: the host reads them at ``print_frequency`` and at the end of an epoch,
and nowhere else in the train loop.

Batches reach the card through :func:`device_prefetch`: the loader's
page-locked batch buffers and a copy stream, so the upload of batch k+1
overlaps the step of batch k. The train step's augmentations draw from the
engine's ``torch.Generator`` on the card, seeded from the engine's seed (a
resume restarts it from the seed, as JAX's engine restarts its key).

Change detection differs in its steps' input assembly and dropout draws
(``steps.py``), its optimizer (``ops/optim.create_cd_optimizer``) and the
per-epoch ``checkpoint_epoch={e}`` saves of ``train_save_checkpoint_freq``.
The recurrent task (the ConvLSTM) differs in its steps' input assembly
(three frames), takes the segmentation optimizer (plain Adam, whatever the
model config's ``optimizer`` and ``betas`` say, as the JAX engine) and
saves ``checkpoint_epoch={e}`` as change detection does. With
``save_visualizations`` each eval draws one batch (``np.random.randint``,
as the JAX engine) and writes its first sample's image, ground truth and
prediction to ``checkpoint_path/viz/{settype}_sample.png``; with
``wandb_activate`` (and wandb installed) the three images go to wandb
instead, as the JAX engine sends them, and every ``print_frequency`` steps
``wandb_watch`` (default on) logs the parameter histograms and per-layer
gradient norms (``utils/logging.MetricLogger.log_watch``). Weights from
the reference's files load at init (``pretrained_checkpoint``,
``pretrained_encoder``, ``pretrained_upernet``).

With a ``MeshPlan`` (``parallel/mesh.py``) the engine runs data parallel, as
the JAX engine runs over its mesh: each rank's loaders decode its row block
of every global batch, the steps reduce over the data group
(``steps.py``), the banks are reduced before every read
(``MetricState.reduce``), so every rank prints the same losses and metrics,
and only rank 0 writes checkpoints (the others wait at a barrier; every rank
reads a resume) and prints the engine's messages.
"""

from __future__ import annotations

import collections
import time
import warnings
from typing import Iterable

import numpy as np
import torch

from ..data.pipeline import Loader
from ..device import configure_backends, resolve_device
from ..ops.losses import create_loss
from ..ops.metrics import HostAOIMetrics, MetricState, derive
from ..ops.schedules import create_lr_schedule
from ..parallel.distributed import is_main_process
from ..parallel.mesh import MeshPlan, broadcast_module
from ..utils.logging import MetricLogger
from .checkpoint import CheckpointManager
from .state import create_train_state
from .steps import STEP_KEYS, TASKS, make_eval_step, make_train_step


def device_prefetch(loader: Iterable[dict], device: str | torch.device, depth: int = 2,
                    keys: tuple = STEP_KEYS):
    """Iterate ``loader``'s batches with their ``keys`` (default the steps'
    ``STEP_KEYS``; MAE's ``("image",)``) on the card, ``depth`` batches in
    flight: each is uploaded on a copy stream, and the compute stream waits
    on that copy's event before it uses the batch. The other keys
    (``activation``, ...) stay on the host as numpy arrays. On the CPU the
    batches pass through unchanged.

    A ``Loader``'s batches are views of its page-locked ring
    (``Loader.ring_batches(pin=True)``): they are uploaded from there, with
    no host copy, and each slot goes back to the ring with its upload's
    event, so the loader refills it only after the copy has read it (the
    host keys are copied first). Any other iterable of numpy batches is
    staged through torch's pinned host allocator."""
    dev = torch.device(device)
    if dev.type != "cuda":
        yield from loader
        return
    copy_stream = torch.cuda.Stream(dev)
    inflight: collections.deque = collections.deque()
    ring = hasattr(loader, "ring_batches")

    def upload(host: dict):
        out, uploaded = {}, []
        with torch.cuda.stream(copy_stream):
            for k, v in host.items():
                if k not in keys:
                    out[k] = v.copy() if ring else v
                    continue
                src = torch.from_numpy(np.ascontiguousarray(v))
                if not ring:
                    src = src.pin_memory()
                out[k] = src.to(dev, non_blocking=True)
                uploaded.append(out[k])
            event = torch.cuda.Event()
            event.record(copy_stream)
        if ring:
            host.release(event)
        return out, uploaded, event

    it = iter(loader.ring_batches(pin=True) if ring else loader)
    try:
        for _ in range(depth):
            host = next(it, None)
            if host is None:
                break
            inflight.append(upload(host))
        while inflight:
            out, uploaded, event = inflight.popleft()
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(event)
            for t in uploaded:
                # allocated on the copy stream: keep the allocator from handing
                # the memory out again while the compute stream may still use it
                t.record_stream(compute)
            yield out
            host = next(it, None)
            if host is not None:
                inflight.append(upload(host))
    finally:
        if hasattr(it, "close"):
            it.close()


class TaskEngine:
    """Owns the model's train state and its two steps for one task."""

    def __init__(self, model: torch.nn.Module, config: dict, model_config: dict, task: str,
                 steps_per_epoch: int, device: str | torch.device | None = "cuda",
                 seed: int = 999, plan: MeshPlan | None = None):
        if task not in TASKS:
            raise NotImplementedError(f"the engine has no task {task!r} (it has {TASKS})")
        self.device = resolve_device(device)
        configure_backends(config, self.device)
        self.model = model
        self.config = config
        self.model_config = model_config
        self.task = task
        self.plan = plan or MeshPlan()
        self.grid = self.plan.data_grid()
        # wandb (wandb_activate) on rank 0 alone
        self.logger = MetricLogger(config, main=is_main_process())
        # the reference's segmentation and recurrent trainers both take plain
        # Adam (JAX engine.py:90-92)
        self.state = create_train_state(model, config, model_config,
                                        "cd" if task == "cd" else "segmentation")
        # the augmentations' and dropout masks' random stream (JAX: the
        # engine's self.rng)
        self.generator = torch.Generator(self.device)
        self.generator.manual_seed(int(seed))
        self.lr_schedule = create_lr_schedule(config, model_config, steps_per_epoch)
        self._load_pretrained_weights()
        broadcast_module(model, self.grid)

        self.with_aoi = bool(config.get("log_AOI_metrics"))
        # wandb.watch-equivalent gradient tracking (reference main.py:144)
        self.with_grad_norm = bool(config.get("wandb_activate") or config.get("log_grad_norm"))
        # wandb.watch parity (main.py:144): per-layer parameter histograms and
        # gradient norms (JAX engine.py:107-110)
        self.with_watch = bool(config.get("wandb_activate")) and bool(
            config.get("wandb_watch", True))
        self._train_step = make_train_step(
            model, create_loss(config, "train"), config, model_config, task, self.device,
            with_grad_norm=self.with_grad_norm, plan=self.plan)
        # eval in f32 like the reference (autocast off at eval,
        # segmentation_trainer.py:321): the same f32 parameters, f32 compute;
        # f32_eval: false evaluates under the bf16 policy
        eval_dtype = None
        if config.get("f32_eval", True) and getattr(model, "dtype", None) == torch.bfloat16:
            eval_dtype = torch.float32
        # each eval draws a batch to visualize, as the JAX engine does; with
        # wandb_activate alone (wandb not installed) it draws and writes no file
        self.viz_enabled = bool(config.get("wandb_activate") or config.get("save_visualizations"))
        self._eval_step = make_eval_step(
            model, create_loss(config, "val"), config, model_config, task, self.device,
            dtype=eval_dtype, with_aoi=self.with_aoi, with_preds=self.viz_enabled,
            plan=self.plan)

    def _load_pretrained_weights(self) -> None:
        """Weights from the reference's files at init (JAX
        ``_load_pretrained_weights``; the reference's smp
        ``encoder_weights="imagenet"``, model_utilities.py:110-157, and
        UperNet's from_pretrained, upernet.py:28-77), the first key set of:

          * ``pretrained_checkpoint``: a torch checkpoint of this method,
            converted whole (``convert.CONVERTERS``);
          * ``pretrained_encoder``: a torchvision ResNet state_dict grafted
            into the model's ``encoder`` (the stem keeps its init where the
            input channels differ from the file's);
          * ``pretrained_upernet``: a local ``save_pretrained`` directory of
            an HF UperNet, its first conv and classifier replaced.

        Each is copied into the model's own tensors (``convert.load_into``:
        strict, in place), so the optimizer steps the loaded values."""
        cfg = self.config
        key = next((k for k in ("pretrained_checkpoint", "pretrained_encoder",
                                "pretrained_upernet") if cfg.get(k)), None)
        if key is None:
            if cfg.get("pretrained") or cfg.get("encoder_weights"):
                # the reference defaults these methods to ImageNet-pretrained
                # encoders (model_utilities.py:110-157); make the gap loud
                warnings.warn(
                    f"config requests pretrained weights (pretrained={cfg.get('pretrained')!r}, "
                    f"encoder_weights={cfg.get('encoder_weights')!r}) for method "
                    f"{cfg.get('method')!r} but no weight source is set — training starts "
                    "from RANDOM init, unlike the reference default. Supply "
                    "'pretrained_encoder' (a torchvision ResNet .pth), 'pretrained_checkpoint' "
                    "(a reference .pt) or 'pretrained_upernet' (a local save_pretrained "
                    "directory); see README 'Pretrained weights'.",
                    stacklevel=2,
                )
            return
        from .. import convert

        model = self.state.model
        if key == "pretrained_checkpoint":
            state = convert.convert(cfg[key], cfg["method"])
        elif key == "pretrained_encoder":
            state = convert.graft_encoder(model.state_dict(), convert.convert_torchvision_resnet(
                convert.load_torch_state_dict(cfg[key])))
        else:
            state = convert.load_pretrained_upernet(cfg[key], cfg["num_channels"],
                                                    cfg.get("num_classes", 3))
        convert.load_into(model, state)
        self.logger.info(f"Loaded {key} {cfg[key]}")

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
                                                             lr_value, self.generator)
            loss, grad_norm = aux if self.with_grad_norm else (aux, None)
            if nbatches % print_every == 0:
                snap = metric_state.reduce(self.grid).cm.cpu().numpy()
                self.logger.log_train_iteration(
                    epoch, nbatches, float(loss), lr_value, derive(snap),
                    grad_norm=None if grad_norm is None else float(grad_norm))
                if self.with_watch:
                    # the step leaves the (reduced) gradients on the parameters
                    self.logger.log_watch(self.model, {
                        n: torch.linalg.vector_norm(p.grad.float())
                        for n, p in self.model.named_parameters() if p.grad is not None})
            nbatches += 1
        summary = metric_state.reduce(self.grid).summarize()
        summary["epoch_time_s"] = time.perf_counter() - t0
        summary["data_wait_s"] = wait
        summary["batches"] = nbatches
        summary["mean_loss"] = float(summary["val_loss"])
        return summary

    def run_eval(self, loader: Loader, settype: str = "Val") -> tuple[float, float, float, dict]:
        """(100·acc, 100·meanF1, 100·mIoU, summary); with ``log_AOI_metrics``
        the summary's ``aoi_banks`` holds the per-activation banks."""
        metric_state = MetricState.create(self.device)
        per_sample, activations, weights = [], [], []
        # one random batch gets its first sample drawn, as the JAX engine
        # (the reference's wandb.Image logging, segmentation_trainer.py:516-587)
        viz_index = int(np.random.randint(0, max(len(loader), 1))) if self.viz_enabled else -1
        for index, batch in enumerate(device_prefetch(loader, self.device)):
            metric_state, _, aux = self._eval_step(self.state, batch, metric_state)
            if self.with_aoi:
                per_sample.append(aux["per_sample_cm"])
                activations.append(np.asarray(batch["activation"]))
                weights.append(torch.as_tensor(batch.get(
                    "sample_weight", np.ones(len(activations[-1]), np.float32))))
            if index == viz_index and is_main_process():
                self._save_visualization(batch, aux["preds"], settype)
        summary = metric_state.reduce(self.grid).summarize()
        aoi_summary = None
        if self.with_aoi:
            aoi = HostAOIMetrics()
            if per_sample:  # one read of the epoch's per-sample matrices
                # padding rows (weight 0) are left out: a rank whose block is
                # all padding holds zero rows of activation 0
                keep = torch.cat([w.cpu() for w in weights]).numpy() > 0
                aoi.update(torch.cat(per_sample).cpu().numpy()[keep],
                           np.concatenate(activations)[keep])
            if self.grid is not None:
                aoi.merge_ranks(self.grid)
            summary["aoi_banks"] = aoi.banks
            aoi_summary = aoi.summarize()
        self.logger.log_eval(settype, summary, aoi_summary)
        return (100.0 * summary["micro_accuracy"], 100.0 * summary["mean_f1"],
                100.0 * summary["mean_iou"], summary)


    def _save_visualization(self, batch: dict, preds: torch.Tensor, settype: str) -> None:
        """Sample 0's triptych (``utils/visualize.prediction_triptych``,
        reverse-scaled with its ``flood_sv1``/``flood_sv2`` where
        ``scale_input`` is set) as one PNG,
        ``checkpoint_path/viz/{settype}_sample.png`` (lower case), with
        ``save_visualizations``; with ``wandb_activate`` and a wandb run
        the three images go to wandb instead (``utils/visualize.to_wandb_images``,
        keys "{settype} image", ...), as the JAX engine sends them."""
        to_wandb = bool(self.config.get("wandb_activate")) and self.logger.wandb is not None
        if not (to_wandb or self.config.get("save_visualizations")):
            return
        import cv2
        from pathlib import Path

        from ..utils.visualize import prediction_triptych, to_wandb_images

        def host(x):
            return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

        sv = None
        if "flood_sv1" in batch and self.config.get("scale_input") is not None:
            sv = (host(batch["flood_sv1"])[0], host(batch["flood_sv2"])[0])
        trip = prediction_triptych(host(batch["post"][0]), host(preds[0]),
                                   host(batch["mask"][0]), sv, self.config)
        if to_wandb:
            self.logger.log({f"{settype} {k}": v for k, v in to_wandb_images(trip).items()})
            return
        out_dir = Path(self.config.get("checkpoint_path", "checkpoints/run")) / "viz"
        out_dir.mkdir(parents=True, exist_ok=True)
        panel = np.concatenate(list(trip.values()), axis=1)
        cv2.imwrite(str(out_dir / f"{settype.lower()}_sample.png"), panel[..., ::-1])


def train_task(model: torch.nn.Module, train_loader: Loader, val_loader: Loader,
               test_loader: Loader, config: dict, model_config: dict, task: str,
               device: str | torch.device | None = "cuda", seed: int = 999,
               plan: MeshPlan | None = None) -> TaskEngine:
    """The training loop: epochs -> val -> best-mIoU checkpoint, then the
    best weights reloaded for the final test eval (reference main.py:151-158).
    ``test_loader`` is the caller's to evaluate."""
    del test_loader
    engine = TaskEngine(model, config, model_config, task, steps_per_epoch=len(train_loader),
                        device=device, seed=seed, plan=plan)
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

    save_freq = (int(config.get("train_save_checkpoint_freq") or 0)
                 if task in ("cd", "recurrent") else 0)
    for epoch in range(start_epoch, int(config.get("epochs", 1))):
        engine.logger.log_train_epoch(epoch, engine.run_train_epoch(train_loader, epoch))
        if save_freq and epoch % save_freq == 0:
            ckpt.save_epoch(engine.state, epoch)
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
                  device: str | torch.device | None = "cuda", seed: int = 999,
                  plan: MeshPlan | None = None) -> TaskEngine:
    """Eval-only engine (the reference's ``"test": true``, main.py:86-128):
    restore best_segmentation and skip training. Raises when there is none,
    rather than scoring a random-init model."""
    engine = TaskEngine(model, config, model_config, task, steps_per_epoch=1, device=device,
                        seed=seed, plan=plan)
    ckpt = CheckpointManager(config.get("checkpoint_path", "checkpoints/run"), engine.device)
    if not ckpt.has("best_segmentation"):
        raise FileNotFoundError(
            f"\"test\": true but no best_segmentation checkpoint in {ckpt.dir}")
    engine.state, extra = ckpt.restore("best_segmentation", engine.state)
    engine.logger.info(f"Eval-only: restored best_segmentation (val mIoU "
                       f"{float(extra.get('metric', float('nan'))):.3f})")
    return engine
