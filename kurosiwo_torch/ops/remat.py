"""Rematerialisation that keeps the JAX package's semantics; counterpart of
``jax.checkpoint`` with ``nothing_saveable`` (the whole-forward remat of the
train step, ``kurosiwo_tpu/training/steps.py:144``) and with
``bn_stats_saveable_policy`` (SNUNet's per-block and per-column plan with
``StatCheckpointBatchNorm``, ``kurosiwo_tpu/ops/nn.py:649-737``).

``remat(fn, *args)`` runs ``fn`` under ``torch.utils.checkpoint``: only the
region's inputs are kept, and its forward runs again in the backward pass.
A plain replay would change what the region computes, so the first forward
of a region records what its stateful layers did and the recompute replays
it:

* each training-mode ``BatchNorm`` (``ops/batchnorm.py``) records its f32
  batch mean and variance. With ``save_bn_stats`` (JAX's saveable policy)
  the recompute normalizes with them and runs no second reduction, so a
  step launches the pair-sum kernel as often as without remat; without it
  the recompute reduces again. Either way the recompute leaves the running
  statistics alone, as ``jax.checkpoint`` discards the mutations of its
  recompute.
* each ``Dropout2d`` and ``DropPath`` (``ops/nn.py``) records its mask,
  which the recompute applies again. ``torch.utils.checkpoint``'s
  ``preserve_rng_state`` restores only the default generators, not the
  explicit ``torch.Generator`` a step draws from, so without this the
  recompute would draw new masks and the gradient would belong to another
  forward.

The layers find the active region through a context variable that ``remat``
sets around each run of ``fn``; outside a region they behave as usual.
Under ``torch.no_grad`` (eval) ``remat`` calls ``fn`` directly, and so it
does inside another region (ChangeFormer's Mix-FFN and tail chunks under
the whole-forward remat): the outer region recomputes it, and its layers
record into and replay from the outer region.
"""

from __future__ import annotations

import contextvars
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("kurosiwo_remat_region", default=None)


class Region:
    """What the first forward of one checkpointed region recorded, in call
    order, and where its recompute has got to."""

    def __init__(self, save_bn_stats: bool):
        self.save_bn_stats = save_bn_stats
        self.replay = False  # set once the first forward has finished
        self.stats: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.masks: list[torch.Tensor] = []
        self._next_stats = 0
        self._next_mask = 0

    def start(self) -> None:
        self._next_stats = self._next_mask = 0

    def record_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if self.save_bn_stats:
            self.stats.append((mean, var))

    def replay_stats(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """The next BatchNorm's recorded statistics, or None when they were
        not saved (the layer reduces again)."""
        if not self.save_bn_stats:
            return None
        out = self.stats[self._next_stats]
        self._next_stats += 1
        return out

    def record_mask(self, mask: torch.Tensor) -> None:
        self.masks.append(mask)

    def replay_mask(self) -> torch.Tensor:
        out = self.masks[self._next_mask]
        self._next_mask += 1
        return out


def active_region() -> Region | None:
    """The region whose forward is running in this context, if any."""
    return _ACTIVE.get()


def remat(fn: Callable, *args, save_bn_stats: bool = True):
    """``fn(*args)``, its activations recomputed in the backward pass (see
    the module docstring). Each call is a region of its own."""
    if not torch.is_grad_enabled() or active_region() is not None:
        return fn(*args)
    region = Region(save_bn_stats)

    def run(*inputs):
        region.start()
        token = _ACTIVE.set(region)
        try:
            return fn(*inputs)
        finally:
            _ACTIVE.reset(token)
            region.replay = True

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
