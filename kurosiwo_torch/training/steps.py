"""Train and eval steps of the segmentation, change-detection and recurrent
tasks; counterpart of ``kurosiwo_tpu/training/steps.py``.

A step keeps its loss, confusion matrix and weight sum on the device: it
never reads a value back to the host, so the card runs ahead of Python.
A step moves to its device only the batch keys it reads (``STEP_KEYS``);
the engine's ``device_prefetch`` has put them there already on the card.
With ``data_augmentations`` the train step augments the batch on its
device first (``data/augment.py``), from the ``torch.Generator`` it is
given; with ``log_zone_metrics`` both steps also fill the per-zone banks.

Change detection (``task="cd"``) feeds the model two frames
(``assemble_cd_inputs``) and hands it the step's generator for its dropout
and drop-path masks. A model that returns a list of heads (ChangeFormer)
goes through ``combine_multiscale``: training scores the last head, and
with ``multi_scale_train`` and ``multi_pred_weights`` the loss is the
weighted sum over the heads, each first resized to the mask's size with
``jax.image.resize``'s "bilinear" (``ops/nn.resize_linear``); eval takes
the last head, or with ``multi_scale_infer`` the mean of the heads after an
integer-factor nearest resize. The recurrent task (``task="recurrent"``)
feeds the ConvLSTM its three frames (``assemble_recurrent_input``); its
probabilities go to the tail as logits, and the tail is the plain one
unless ``fused_tail`` is true (B2's NHWC kernels), as JAX resolves it. With ``remat`` the forward of every method
but SNUNet runs as one rematerialized region (``ops/remat.remat``; JAX's
whole-forward ``jax.checkpoint``, ``steps.py:144``); SNUNet checkpoints its
own blocks and columns, as the factory configures it. The JAX whole-forward
policy, ``nothing_saveable``, recomputes the BatchNorm statistics; the port
keeps them across the region instead, the same values at (C,) floats a
layer, so remat adds no pair-sum launch.

With a ``MeshPlan`` whose groups exist (``parallel/mesh.py``) a step runs
data parallel: the batch it is given is this rank's row block of the global
batch, and the step computes what one process computes on the global batch,
as the JAX step does under GSPMD. The BatchNorm statistics, the loss and the
random draws are the global batch's (``ops/batchnorm.py``,
``ops/losses.py``, ``parallel/mesh.draw_rows``), the ranks' gradients are
summed in one all-reduce before the optimizer step, and the metric banks
hold this rank's rows until the engine reduces them
(``MetricState.reduce``). The fused CE+cm tail stays off above one process.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..data.augment import augment_batch, check_augmentations
from ..device import resolve_device
from ..ops.fused_tail import fused_ce_cm, resolve_fused_tail
from ..ops.metrics import MetricState, per_sample_confusion
from ..ops.nn import resize_linear, resize_nearest
from ..ops.optim import set_learning_rate
from ..ops.remat import remat
from ..parallel.mesh import MeshPlan, sync_gradients, use_grid
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


_FRAMES = {"pre_event_1": "pre1", "pre_event_2": "pre2", "post_event": "post"}


def assemble_cd_inputs(batch: dict, config: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The two frames of a change-detection step, in ``inputs`` order, each
    with the DEM appended when ``dem`` is set."""
    inputs = config["inputs"]
    if len(inputs) != 2:
        raise ValueError(f"change detection requires exactly 2 inputs, got {inputs}")
    frames = []
    for name in inputs:
        f = batch[_FRAMES[name]]
        if config.get("dem"):
            f = torch.cat([f, batch["dem"]], dim=-1)
        frames.append(f)
    return frames[0], frames[1]


def assemble_recurrent_input(batch: dict, config: dict) -> torch.Tensor:
    """(B, T=3, H, W, C) frames in the reference's order (pre2, pre1, post),
    each with the DEM appended when ``dem`` is set."""
    frames = [batch["pre2"], batch["pre1"], batch["post"]]
    if config.get("dem"):
        frames = [torch.cat([f, batch["dem"]], dim=-1) for f in frames]
    return torch.stack(frames, dim=1)


# the batch keys a step reads (valid for the augmentations' discard-if-empty,
# clz for the zone banks)
STEP_KEYS = ("post", "pre1", "pre2", "dem", "mask", "valid", "sample_weight", "clz")


def _to_device(batch: dict, device: torch.device) -> dict:
    """The batch's ``STEP_KEYS`` on the step's device (no copy when they are
    there); masks become int32, the kernels' label type."""
    out = {}
    for k in STEP_KEYS:
        if k in batch:
            v = torch.as_tensor(batch[k])
            if k in ("mask", "valid", "clz"):
                v = v.to(torch.int32)
            out[k] = v.to(device, non_blocking=True)
    return out


TASKS = ("segmentation", "cd", "recurrent")


def _check_task(task: str) -> None:
    if task not in TASKS:
        raise NotImplementedError(f"the steps have no task {task!r} (they have {TASKS})")


def _check_ported_keys(config: dict, train: bool) -> None:
    """Raise, when the step is built, on a config key that the JAX step
    honours and this one does not: an unsupported augmentation with p > 0."""
    if train and config.get("data_augmentations"):
        check_augmentations(config)


def _forward(model: torch.nn.Module, batch: dict, config: dict, task: str,
             dtype: torch.dtype | None = None, generator: torch.Generator | None = None,
             use_remat: bool = False) -> torch.Tensor | list[torch.Tensor]:
    """The model's output on the batch's assembled input(s)."""
    if task == "segmentation":
        inputs, kw = (assemble_segmentation_input(batch, config),), {"dtype": dtype}
    elif task == "recurrent":
        inputs, kw = (assemble_recurrent_input(batch, config),), {"dtype": dtype}
    else:
        inputs, kw = assemble_cd_inputs(batch, config), {"dtype": dtype, "generator": generator}
    if use_remat:
        return remat(lambda *xs: model(*xs, **kw), *inputs)
    return model(*inputs, **kw)


def combine_multiscale(outputs, model_config: dict, train: bool):
    """(logits, heads) of a model's output (JAX ``_combine_multiscale``,
    ``steps.py:91-109``): a tensor is the logits; of a list, training takes
    the last head for the metrics and all of them for deep supervision;
    eval takes the last head, or with ``multi_scale_infer`` the mean of the
    heads resized (nearest) to the last one's size."""
    if not isinstance(outputs, (list, tuple)):
        return outputs, None
    if train:
        return outputs[-1], outputs
    if model_config.get("multi_scale_infer"):
        size = tuple(outputs[-1].shape[1:3])
        acc = torch.zeros_like(outputs[-1])
        for o in outputs:
            acc = acc + (resize_nearest(o, size) if tuple(o.shape[1:3]) != size else o)
        return acc / len(outputs), None
    return outputs[-1], None


def multiscale_loss(criterion: Callable, heads: list, mask: torch.Tensor,
                    weights) -> torch.Tensor:
    """sum_i w_i * criterion(head_i at the mask's size, mask), the JAX step's
    deep-supervision loss (``steps.py:201-210``)."""
    size = tuple(mask.shape[1:3])
    loss = None
    for w, head in zip(weights, heads):
        if tuple(head.shape[1:3]) != size:
            head = resize_linear(head, size)
        term = w * criterion(head, mask)
        loss = term if loss is None else loss + term
    return loss


def _fill_missing_grads(model: torch.nn.Module) -> None:
    """A zero gradient for every parameter the forward did not reach (BiT's
    layer4 at ``resnet_stages_num`` 4, which runs but feeds nothing), so the
    optimizer updates the whole tree as optax does: SGD's weight decay and
    Adam's moments move them too."""
    for p in model.parameters():
        if p.grad is None and p.requires_grad:
            p.grad = torch.zeros_like(p)


def make_train_step(model: torch.nn.Module, criterion: Callable, config: dict,
                    model_config: dict, task: str = "segmentation",
                    device: str | torch.device | None = "cuda", with_grad_norm: bool = False,
                    plan: MeshPlan | None = None):
    """Returns ``train_step(state, batch, metric_state, lr, generator=None)
    -> (state, metric_state, aux)``: aux is the loss, or ``(loss,
    grad_norm)`` with ``with_grad_norm``, the global f32 norm of the
    gradients (the reference's wandb.watch gradient tracking as one scalar).
    With ``data_augmentations`` and ``augmentations`` the batch is augmented
    on the step's device from ``generator`` (required then) before the input
    is assembled. The loss/metrics tail is the fused CE+cm kernel when
    ``resolve_fused_tail`` selects it (the default for the UNet on one CUDA
    device), else ``criterion`` plus a confusion matrix of the argmax (and
    the zone banks with ``log_zone_metrics``). A change-detection model
    draws its dropout masks from ``generator`` (None: torch's default
    generator of the device); ``remat`` and the multi-scale heads are
    honoured as the module docstring says. ``plan`` makes the step data
    parallel over its data group (see the module docstring)."""
    _check_task(task)
    _check_ported_keys(config, train=True)
    grid = plan.data_grid() if plan is not None else None
    dev = resolve_device(device)
    use_remat = bool(config.get("remat")) and config.get("method") != "snunet"
    use_fused = bool(resolve_fused_tail(config, task, model_config, device=dev))
    use_augment = bool(config.get("data_augmentations")) and bool(config.get("augmentations"))
    with_zones = bool(config.get("log_zone_metrics"))
    multi_weights = model_config.get("multi_pred_weights")
    use_multiscale_loss = bool(model_config.get("multi_scale_train")) and multi_weights is not None
    cw = torch.tensor(config.get("class_weights", [1.0, 1.0, 1.0]), dtype=torch.float32,
                      device=dev)

    def train_step(state: TrainState, batch: dict, metric_state: MetricState, lr: float,
                   generator: torch.Generator | None = None):
        with use_grid(grid):
            return _train_step(state, batch, metric_state, lr, generator)

    def _train_step(state, batch, metric_state, lr, generator):
        batch = _to_device(batch, dev)
        if use_augment:
            if generator is None:
                raise ValueError("data_augmentations needs the step's torch.Generator")
            batch = augment_batch(generator, batch, config)
        model.train()
        set_learning_rate(state.optimizer, lr)
        mask = batch["mask"]
        out = _forward(model, batch, config, task, generator=generator, use_remat=use_remat)
        logits, heads = combine_multiscale(out, model_config, train=True)
        if use_fused:
            loss, cm = fused_ce_cm(logits, mask, cw)
        elif use_multiscale_loss and heads is not None:
            loss = multiscale_loss(criterion, heads, mask, multi_weights)
        else:
            loss = criterion(logits, mask)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _fill_missing_grads(model)
        sync_gradients(model.parameters(), grid)
        if with_grad_norm:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        state.optimizer.step()
        bsz = float(mask.shape[0])
        if use_fused:
            metric_state = metric_state.update_from_cm(cm, loss, bsz)
        else:
            metric_state = metric_state.update(torch.argmax(logits.detach(), dim=-1), mask, loss,
                                               bsz, clz=batch["clz"] if with_zones else None)
        state.step += 1
        if with_grad_norm:
            return state, metric_state, (loss.detach(), grad_norm)
        return state, metric_state, loss.detach()

    return train_step


def make_eval_step(model: torch.nn.Module, criterion: Callable, config: dict,
                   model_config: dict, task: str = "segmentation",
                   device: str | torch.device | None = "cuda",
                   dtype: torch.dtype | None = None, with_aoi: bool = False,
                   with_preds: bool = False, plan: MeshPlan | None = None):
    """Returns ``eval_step(state, batch, metric_state) -> (metric_state,
    loss, aux)``. ``dtype=torch.float32`` is the f32 twin: the same
    parameters evaluated in f32 compute (the engine's ``f32_eval``).
    ``aux["per_sample_cm"]`` (with ``with_aoi``) holds each sample's (4, 4)
    confusion matrix for the host's AOI banks, ``aux["preds"]`` (with
    ``with_preds``) the argmax map.

    The loss is unweighted cross entropy on all pixels, as the reference's
    eval; samples with ``sample_weight`` 0 are dropped from the cm bank.
    Where the fused tail applies, loss and cm come from the CE+cm forward
    kernel at class weights (1, 1, 1), the same function as
    ``create_loss(mode="val")`` plus ``confusion_matrix``.

    ``config["eval_microbatch"] = M`` (0 or absent: off) runs the batch as
    B / M chunks of M, one after the other, which caps the live activations
    at one chunk (the JAX ``chunked_eval_step``). The banks are those of the
    whole batch; the returned loss is the mean of the chunks' losses. A
    batch of at most M samples, or one that M does not divide, runs whole.
    With ``log_zone_metrics`` the zone banks are filled too (the fused tail
    is then off). ``plan``: the loss is the global batch's, as in the train
    step; the banks hold this rank's rows until ``MetricState.reduce``."""
    _check_task(task)
    _check_ported_keys(config, train=False)
    grid = plan.data_grid() if plan is not None else None
    dev = resolve_device(device)
    use_fused = bool(resolve_fused_tail(config, task, model_config, strict=False, device=dev))
    with_zones = bool(config.get("log_zone_metrics"))
    ones = torch.ones(3, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, metric_state: MetricState):
        with use_grid(grid):
            return _eval_step(batch, metric_state)

    def _eval_step(batch, metric_state):
        batch = _to_device(batch, dev)
        model.eval()
        mask = batch["mask"]
        logits, _ = combine_multiscale(_forward(model, batch, config, task, dtype=dtype),
                                       model_config, train=False)
        sample_w = batch.get("sample_weight")
        bank_mask = mask
        if sample_w is not None:
            bank_mask = torch.where(sample_w[:, None, None] > 0, mask, torch.full_like(mask, 3))
        preds = torch.argmax(logits, dim=-1) if (with_aoi or with_preds or not use_fused) else None
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
            metric_state = metric_state.update(preds, bank_mask, loss, bsz,
                                               clz=batch["clz"] if with_zones else None)
        aux = {}
        if with_aoi:
            aux["per_sample_cm"] = per_sample_confusion(preds, bank_mask)
        if with_preds:
            aux["preds"] = preds
        return metric_state, loss, aux

    microbatch = int(config.get("eval_microbatch") or 0)
    if not microbatch:
        return eval_step

    def chunked_eval_step(state: TrainState, batch: dict, metric_state: MetricState):
        batch = _to_device(batch, dev)
        bsz = batch["mask"].shape[0]
        if bsz <= microbatch or bsz % microbatch:
            return eval_step(state, batch, metric_state)
        losses, auxes = [], []
        for lo in range(0, bsz, microbatch):
            chunk = {k: v[lo:lo + microbatch] for k, v in batch.items()}
            metric_state, loss, aux = eval_step(state, chunk, metric_state)
            losses.append(loss)
            auxes.append(aux)
        aux = {k: torch.cat([a[k] for a in auxes]) for k in auxes[0]}
        return metric_state, torch.stack(losses).mean(), aux

    return chunked_eval_step
