"""Device selection: the port runs on the card unless the caller asks for
the CPU (as the tests do). No entry point falls back to the CPU silently."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def configure_backends() -> None:
    """The backend flags of every entry point on the card: TF32 off (so the
    f32 eval twin computes in f32, like the reference's eval) and cuDNN's
    autotuner on. The engine and the bench set the same flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
