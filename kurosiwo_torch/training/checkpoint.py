"""Checkpoints; counterpart of ``kurosiwo_tpu/training/checkpoint.py`` on
``torch.save`` in place of orbax. The same conventions:

  * the best-val checkpoint is ``best_segmentation`` (selection metric: val
    mIoU over classes 0-2), beside a human-readable ``best_segmentation.txt``;
  * per-epoch checkpoints ``checkpoint_epoch={e}``;
  * the rolling ``latest`` that resume reads first.

A checkpoint holds the whole train state: the model's ``state_dict`` (f32
parameters and the BatchNorm ``mean``/``var`` buffers), the optimizer's
``state_dict`` (Adam's moments, or ``AdamBF16Moments``' bf16 ones, and their
step) and the step count; the caller's ``extra`` (epoch, metric) rides in the
pointer.

Preemption-safe layout: each name alternates between the files ``{name}.a``
and ``{name}.b``, and ``{name}.ptr.json`` names the committed one. A save
writes the slot the pointer does not name, flushes and fsyncs it, and only
then replaces the pointer (``os.replace`` of an fsynced temporary file), so
at every instant the pointer names a fully written file, and a save that
fails leaves the previous copy restorable.

Saves are synchronous: the card waits while the state is copied to the host
and written. The JAX package saves asynchronously only so that the TPU does
not wait; at epoch cadence the wait is short.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from .state import TrainState


def _fsync_write(path: Path, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    def __init__(self, directory: str | Path, device: str | torch.device = "cpu"):
        """``device`` is where ``restore`` maps the saved tensors (the
        engine's device)."""
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.device = torch.device(device)

    def _ptr_path(self, name: str) -> Path:
        return self.dir / f"{name}.ptr.json"

    def _read_ptr(self, name: str) -> dict | None:
        p = self._ptr_path(name)
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            return None

    def has(self, name: str) -> bool:
        return self._read_ptr(name) is not None

    def save(self, name: str, state: TrainState, extra: dict | None = None) -> None:
        cur = self._read_ptr(name)
        slot = f"{name}.b" if cur and cur.get("slot", "").endswith(".a") else f"{name}.a"
        payload = {"step": int(state.step), "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict()}
        # the pointer names the other slot until the replace below
        _fsync_write(self.dir / slot, lambda f: torch.save(payload, f))
        ptr = self._ptr_path(name)
        tmp = ptr.with_suffix(".json.tmp")
        text = json.dumps({"slot": slot, "extra": dict(extra or {})}).encode()
        _fsync_write(tmp, lambda f: f.write(text))
        os.replace(tmp, ptr)
        dir_fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)

    def save_best(self, state: TrainState, epoch: int, metric: float) -> None:
        self.save("best_segmentation", state, extra={"epoch": epoch, "metric": metric})
        (self.dir / "best_segmentation.txt").write_text(f"epoch: {epoch}\nval_miou: {metric}\n")

    def save_epoch(self, state: TrainState, epoch: int) -> None:
        self.save(f"checkpoint_epoch={epoch}", state)

    def load(self, name: str, map_location: str | torch.device | None = None) -> tuple[dict, dict]:
        """The committed payload of ``name`` ({"step", "model", "optimizer"},
        its tensors on ``map_location``, default the manager's device) and
        its extra."""
        ptr = self._read_ptr(name)
        if ptr is None:
            raise FileNotFoundError(f"no checkpoint named {name!r} under {self.dir}")
        payload = torch.load(self.dir / ptr["slot"], weights_only=True,
                             map_location=self.device if map_location is None else map_location)
        return payload, dict(ptr.get("extra") or {})

    def restore(self, name: str, state: TrainState) -> tuple[TrainState, dict]:
        """Load ``name`` into ``state``'s model and optimizer in place."""
        payload, extra = self.load(name)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        _steps_to_host(state.optimizer)
        state.step = int(payload["step"])
        return state, extra


def _steps_to_host(optimizer: torch.optim.Optimizer) -> None:
    """``load_state_dict`` leaves a loaded ``step`` where the file was mapped;
    a torch optimizer that is neither capturable nor fused keeps it on the
    CPU, as it made it (on the card, reading it would cost a host sync for
    every parameter at every step)."""
    for group in optimizer.param_groups:
        if group.get("capturable") or group.get("fused"):
            continue
        for p in group["params"]:
            s = optimizer.state.get(p)
            if s is not None and torch.is_tensor(s.get("step")):
                s["step"] = s["step"].cpu()
