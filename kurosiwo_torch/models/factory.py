"""Model factory; counterpart of ``kurosiwo_tpu/models/factory.py``. The
UNet and the MAE (ViT encoder) are ported; every other method names its
``ROADMAP.md`` item."""

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
    asks for the CPU), f32 parameters from a seeded ``torch.Generator``.
    Config keys ``conv_bn_kernel`` and ``dw_kernel`` (default off) open the
    UNet's B6 and B7 conv routes (``ops/nn.ConvBNAct``)."""
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
            conv_bn_kernel=bool(config.get("conv_bn_kernel", False)),
            dw_kernel=bool(config.get("dw_kernel", False)),
        )
        return model.to(dev)
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"segmentation method {method!r} is not ported yet (ROADMAP.md, {_NOT_PORTED[method]})")
    raise NotImplementedError(f"segmentation method {method!r} is not supported")


def build_mae(config: dict, model_config: dict, device: str | torch.device | None = "cuda",
              seed: int = 0):
    """MAE = ViT encoder (pool "cls") + MAE wrapper on ``device``, f32
    parameters from a seeded ``torch.Generator`` (JAX ``build_mae``,
    ``factory.py:173-198``)."""
    from .mae import MAE
    from .vit import ViT

    dev = resolve_device(device)
    dt = compute_dtype(config)
    g = torch.Generator().manual_seed(seed)
    channels = int(config["num_channels"])
    encoder = ViT(
        image_size=model_config.get("image_size", 224),
        patch_size=model_config.get("patch_size", 16),
        num_classes=model_config.get("num_classes", 1000),
        dim=model_config.get("dim", 1024),
        depth=model_config.get("depth", 24),
        heads=model_config.get("heads", 16),
        mlp_dim=model_config.get("mlp_dim", 2048),
        channels=channels,
        pool="cls",
        dtype=dt,
        generator=g,
    )
    model = MAE(
        encoder,
        decoder_dim=model_config.get("decoder_dim", 512),
        masking_ratio=model_config.get("masked_ratio", 0.75),
        decoder_depth=model_config.get("decoder_depth", 8),
        decoder_heads=model_config.get("decoder_heads", 16),
        channels=channels,
        dtype=dt,
        generator=g,
    )
    return model.to(dev)
