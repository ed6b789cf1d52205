"""Train and eval steps of the segmentation task; counterpart of
``kurosiwo_tpu/training/steps.py``.

A step keeps its loss, confusion matrix and weight sum on the device: it
never reads a value back to the host, so the card runs ahead of Python.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from ..ops.fused_tail import fused_ce_cm, resolve_fused_tail
from ..ops.metrics import MetricState
from ..ops.optim import set_learning_rate
from .state import TrainState


def assemble_segmentation_input(batch: dict, config: dict) -> torch.Tensor:
    """Channel-concat input assembly (NHWC): post (+DEM), then pre1, pre2."""
    inputs = config["inputs"]
    image = batch["post"]
    if config.get("dem"):
        image = torch.cat([image, batch["dem"]], dim=-1)
    parts = [image]
    in_set = set(inputs)
    if in_set == {"post_event"}:
        pass
    elif in_set == {"pre_event_1", "post_event"}:
        parts.append(batch["pre1"])
    elif in_set == {"pre_event_2", "post_event"}:
        parts.append(batch["pre2"])
    elif in_set == {"pre_event_1", "pre_event_2", "post_event"}:
        parts.append(batch["pre1"])
        parts.append(batch["pre2"])
    else:
        raise ValueError(f'Invalid configuration for "inputs": {inputs}')
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def _to_device(batch: dict, device: torch.device) -> dict:
    """Move a batch to the step's device (no copy when it is there);
    masks become int32, the kernels' label type."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if k == "mask":
            v = v.to(torch.int32)
        out[k] = v.to(device, non_blocking=True)
    return out


def _check_task(task: str) -> None:
    if task != "segmentation":
        raise NotImplementedError(f"task {task!r} is not ported yet (ROADMAP.md, A6-A10)")


def _check_ported_keys(config: dict, train: bool) -> None:
    """Raise on a config key that the JAX step honours and this one does
    not, when the step is built: a step that dropped it would compute
    another function (augmented batches, per-zone banks) or hold other
    memory (remat, eval micro-batches)."""
    if config.get("log_zone_metrics"):
        raise NotImplementedError("log_zone_metrics (per-zone metric banks) is not ported yet "
                                  "(ROADMAP.md, A1)")
    if train and config.get("data_augmentations") and config.get("augmentations"):
        raise NotImplementedError("data_augmentations (augment_batch in the train step) is not "
                                  "ported yet (ROADMAP.md, A1)")
    if train and config.get("remat"):
        raise NotImplementedError("remat is not ported yet (ROADMAP.md, A4)")
    if not train and int(config.get("eval_microbatch") or 0) > 0:
        raise NotImplementedError("eval_microbatch (chunked_eval_step) is not ported yet "
                                  "(ROADMAP.md, A4)")


def make_train_step(model: torch.nn.Module, criterion: Callable, config: dict,
                    model_config: dict, task: str = "segmentation",
                    device: str | torch.device | None = "cuda"):
    """Returns ``train_step(state, batch, metric_state, lr) -> (state,
    metric_state, loss)``. The loss/metrics tail is the fused CE+cm kernel
    when ``resolve_fused_tail`` selects it (the default for the UNet on one
    CUDA device), else ``criterion`` plus a confusion matrix of the argmax.
    Raises NotImplementedError for ``log_zone_metrics``, ``remat`` and
    ``data_augmentations`` with ``augmentations``, which it does not honour
    yet."""
    _check_task(task)
    _check_ported_keys(config, train=True)
    dev = resolve_device(device)
    use_fused = bool(resolve_fused_tail(config, task, model_config, device=dev))
    cw = torch.tensor(config.get("class_weights", [1.0, 1.0, 1.0]), dtype=torch.float32,
                      device=dev)

    def train_step(state: TrainState, batch: dict, metric_state: MetricState, lr: float):
        batch = _to_device(batch, dev)
        model.train()
        set_learning_rate(state.optimizer, lr)
        mask = batch["mask"]
        logits = model(assemble_segmentation_input(batch, config))
        if use_fused:
            loss, cm = fused_ce_cm(logits, mask, cw)
        else:
            loss = criterion(logits, mask)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        bsz = float(mask.shape[0])
        if use_fused:
            metric_state = metric_state.update_from_cm(cm, loss, bsz)
        else:
            metric_state = metric_state.update(torch.argmax(logits.detach(), dim=-1), mask, loss, bsz)
        state.step += 1
        return state, metric_state, loss.detach()

    return train_step


def make_eval_step(model: torch.nn.Module, criterion: Callable, config: dict,
                   model_config: dict, task: str = "segmentation",
                   device: str | torch.device | None = "cuda",
                   dtype: torch.dtype | None = None, with_preds: bool = False):
    """Returns ``eval_step(state, batch, metric_state) -> (metric_state,
    loss, aux)``. ``dtype=torch.float32`` is the f32 twin: the same
    parameters evaluated in f32 compute (the engine's ``f32_eval``).

    The loss is unweighted cross entropy on all pixels, as the reference's
    eval; samples with ``sample_weight`` 0 are dropped from the cm bank.
    Where the fused tail applies, loss and cm come from the CE+cm forward
    kernel at class weights (1, 1, 1), the same function as
    ``create_loss(mode="val")`` plus ``confusion_matrix``. Raises
    NotImplementedError for ``log_zone_metrics`` and ``eval_microbatch`` >
    0, which it does not honour yet."""
    _check_task(task)
    _check_ported_keys(config, train=False)
    dev = resolve_device(device)
    use_fused = bool(resolve_fused_tail(config, task, model_config, strict=False, device=dev))
    ones = torch.ones(3, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, metric_state: MetricState):
        batch = _to_device(batch, dev)
        model.eval()
        mask = batch["mask"]
        logits = model(assemble_segmentation_input(batch, config), dtype=dtype)
        sample_w = batch.get("sample_weight")
        bank_mask = mask
        if sample_w is not None:
            bank_mask = torch.where(sample_w[:, None, None] > 0, mask, torch.full_like(mask, 3))
        if use_fused:
            loss, cm = fused_ce_cm(logits, mask, ones)
            if sample_w is not None:
                _, cm = fused_ce_cm(logits, bank_mask, ones)
        else:
            loss = criterion(logits, mask)
            cm = None
        bsz = sample_w.float().sum() if sample_w is not None else float(mask.shape[0])
        if cm is not None:
            metric_state = metric_state.update_from_cm(cm, loss, bsz)
        else:
            metric_state = metric_state.update(torch.argmax(logits, dim=-1), bank_mask, loss, bsz)
        aux = {"preds": torch.argmax(logits, dim=-1)} if with_preds else {}
        return metric_state, loss, aux

    return eval_step
