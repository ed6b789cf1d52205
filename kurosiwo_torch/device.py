"""Device selection: the port runs on the card unless the caller asks for
the CPU (as the tests do). No entry point falls back to the CPU silently."""

from __future__ import annotations

import os

import torch

# the tasks whose configs default ``deterministic`` to true, so that one seed
# gives one number. Segmentation: the CLI's test mIoU moved by up to 1.02
# between runs at one seed with cuDNN's autotuner and not at all with
# deterministic algorithms, for a train step 4-6% slower. Change detection
# for the same reason (PERF.md §6 has its cost). Diffusion: its b128 step ran
# at 149.70 patches/s deterministic and 150.45 autotuned (NVIDIA H100 80GB
# HBM3, 700 W), and the autotuner's first step costs seconds of every run.
# The ViT paths keep the default off: with it the MAE step ran 22-27% and the
# scene encode 28-35% slower.
DETERMINISTIC_TASKS = ("segmentation", "cd", "diffusion-unsup")


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def configure_backends(config: dict | None = None,
                       device: str | torch.device | None = "cuda") -> None:
    """The backend flags of every entry point: TF32 off (so the f32 eval twin
    computes in f32, like the reference's eval). On the card, the config's
    ``deterministic`` (default: true for a task in ``DETERMINISTIC_TASKS``)
    picks between cuDNN's autotuner and deterministic algorithms everywhere
    (``torch.use_deterministic_algorithms``, cuBLAS's fixed workspace), which
    make two runs at one seed give the same numbers; an op with no
    deterministic form on the card then raises. Call it before the first
    cuBLAS call: the workspace setting is read there. The CPU's ops are
    deterministic already, and its flags are left alone."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.device("cuda" if device is None else device).type != "cuda":
        return
    config = config or {}
    deterministic = bool(config.get("deterministic",
                                    config.get("task") in DETERMINISTIC_TASKS))
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.benchmark = not deterministic
    torch.backends.cudnn.deterministic = deterministic
    torch.use_deterministic_algorithms(deterministic)
    # no NaN fill of every new tensor: the port reads no uninitialized memory
    torch.utils.deterministic.fill_uninitialized_memory = False
