"""Profiling and tracing hooks; counterpart of
``kurosiwo_tpu/utils/profiling.py``.

The reference has only ad hoc wall-clock sums (train_mae.py:56-63) and an
uncalled print_model_stats helper (convlstm.py:12-26). Here:
  * ``trace``: a ``torch.profiler`` trace of everything inside the block
    (the card's activity where there is a card), written as a Chrome trace
    under ``log_dir`` and kept on the profiler object for ``key_averages``;
  * ``StepTimer``: step time and patches/s/card, the north-star metric,
    with the device synchronised before each reading (``sync``);
  * parameter accounting for model cards (``count_params``,
    ``param_bytes``, ``model_stats``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str = "kurosiwo_trace"):
    """Profile everything inside the block with ``torch.profiler`` (CPU
    activity, and the card's where CUDA is available); on exit the trace is
    written to ``log_dir/trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def sync(x=None) -> float | None:
    """Wait for the device: the current CUDA stream's work done, or, given
    a tensor, its first element read to the host (returned)."""
    if torch.is_tensor(x):
        return float(x.reshape(-1)[0].item())
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return None


class StepTimer:
    """Rolling step time and throughput; ``num_chips`` is the number of
    cards the batch runs on (patches/s/card)."""

    def __init__(self, batch_size: int, num_chips: int = 1, window: int = 50):
        self.batch_size = batch_size
        self.num_chips = max(num_chips, 1)
        self.window = window
        self._times: list[float] = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        """The step's seconds; ``sync_value`` (a tensor of the step) is
        waited for first, else the device."""
        sync(sync_value)
        dt = time.perf_counter() - self._last
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @property
    def mean_step_time(self) -> float:
        return float(np.mean(self._times)) if self._times else 0.0

    @property
    def patches_per_sec_per_chip(self) -> float:
        t = self.mean_step_time
        return self.batch_size / t / self.num_chips if t > 0 else 0.0

    def summary(self) -> dict:
        return {
            "mean_step_time_s": self.mean_step_time,
            "patches_per_sec_per_chip": self.patches_per_sec_per_chip,
            "steps_measured": len(self._times),
        }


def _tensors(params):
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return list(params.values())
    return list(params)


def count_params(params) -> int:
    """Elements of a module's parameters (or a dict or list of tensors)."""
    return sum(int(np.prod(tuple(p.shape))) for p in _tensors(params))


def param_bytes(params) -> int:
    return sum(int(np.prod(tuple(p.shape))) * p.element_size() for p in _tensors(params))


def model_stats(model: torch.nn.Module) -> dict:
    """print_model_stats parity (convlstm.py:12-21): the parameters' count
    and bytes, the BatchNorm statistics' count, and each card's memory in
    use and at its peak."""
    stats = {"num_params": count_params(model), "param_bytes": param_bytes(model)}
    stats_buffers = [b for n, b in model.named_buffers() if n.rsplit(".", 1)[-1] in ("mean", "var")]
    if stats_buffers:
        stats["num_batch_stats"] = count_params(stats_buffers)
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats[f"{i}_bytes_in_use"] = torch.cuda.memory_allocated(i)
            stats[f"{i}_peak_bytes"] = torch.cuda.max_memory_allocated(i)
    return stats
