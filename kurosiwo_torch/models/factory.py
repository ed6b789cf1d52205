"""Model factory; counterpart of ``kurosiwo_tpu/models/factory.py``. Only
the UNet is ported; every other method names its ``ROADMAP.md`` item."""

from __future__ import annotations

import torch

from ..device import resolve_device

_NOT_PORTED = {
    "unetplusplus": "A5", "unet++": "A5", "deeplabv3": "A5", "finetune": "A5",
    "upernet": "A9",
}


def compute_dtype(config: dict) -> torch.dtype:
    return torch.bfloat16 if config.get("mixed_precision", True) else torch.float32


def initialize_segmentation_model(config: dict, model_config: dict,
                                  device: str | torch.device | None = "cuda", seed: int = 0):
    """The segmentation model on ``device`` (the card unless the caller
    asks for the CPU), f32 parameters from a seeded ``torch.Generator``."""
    dev = resolve_device(device)
    method = config["method"].lower()
    if config.get("task") == "diffusion-unsup":
        raise NotImplementedError("diffusion is not ported yet (ROADMAP.md, A10)")
    if method == "unet":
        from .unet import UNet

        model = UNet(
            in_channels=int(config["num_channels"]), num_classes=int(config["num_classes"]),
            backbone=model_config.get("backbone", "resnet18"), dtype=compute_dtype(config),
            generator=torch.Generator().manual_seed(seed),
        )
        return model.to(dev)
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"segmentation method {method!r} is not ported yet (ROADMAP.md, {_NOT_PORTED[method]})")
    raise NotImplementedError(f"segmentation method {method!r} is not supported")
