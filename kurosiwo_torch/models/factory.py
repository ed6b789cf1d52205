"""Model factory; counterpart of ``kurosiwo_tpu/models/factory.py``. Every
segmentation method (UNet, UNet++, DeepLabV3+ on resnet18/34/50/101;
UperNet on convnext_tiny/small/base and swin_tiny/small/base; the FloodViT
finetuner with its mlp, decoder and linear heads), the MAE (ViT encoder),
the recurrent ConvLSTM and every change-detection model (SNUNet-ECAM,
Siam-diff, Siam-conc, BiT-CD, HFA-Net, ChangeFormerV6, ADHR-CDNet,
TransUNet-CD) and the diffusion task's DDPM (``models/diffusion.py``)
are ported."""

from __future__ import annotations

import torch

from ..device import resolve_device

#: every method the JAX package's ``initialize_cd_model`` builds
CD_METHODS = ("siam-conc", "siam-diff", "snunet", "bit-cd", "hfa-net", "changeformer",
              "adhr-cdnet", "transunet-cd")
#: the change-detection methods the port builds: all of them
PORTED_CD_METHODS = CD_METHODS


def compute_dtype(config: dict) -> torch.dtype:
    return torch.bfloat16 if config.get("mixed_precision", True) else torch.float32


def initialize_segmentation_model(config: dict, model_config: dict,
                                  device: str | torch.device | None = "cuda", seed: int = 0):
    """The segmentation model on ``device`` (the card unless the caller
    asks for the CPU), f32 parameters from a seeded ``torch.Generator``,
    with the JAX factory's keys and defaults (``factory.py:25-84``):
    ``backbone`` from the model config (resnet18 for the UNet, UNet++ and
    DeepLabV3+, convnext_tiny for UperNet; ``backbone_spec``, a key of the
    port's that the JAX factory does not read, sizes UperNet's backbone as
    the JAX tests' override does, for small builds); the finetuner's ViT from the config's
    ``image_size``, ``finetuning_patch_size``, ``dim``, ``depth``,
    ``heads`` and ``mlp_dim`` (defaults 224, 16, 1024, 24, 16, 2048), its
    head ``mlp`` if the config sets ``mlp``, else ``decoder`` if it sets
    ``decoder``, else ``linear``. The finetune config's ``encoder`` key (a
    FloodViT checkpoint path) is read by neither package's engine and is
    left unread here; training starts from the seeded init. The finetuner
    is built for inputs of side ``image_size``: a ``synthetic_patch_size``
    that differs raises, naming both keys. A Swin UperNet is built for
    min(224, ``synthetic_patch_size``), the side the JAX engine inits at.
    Config keys ``conv_bn_kernel`` and ``dw_kernel`` (default off) open the
    UNet's B6 and B7 conv routes (``ops/nn.ConvBNAct``), UNet-only as in
    the JAX package."""
    dev = resolve_device(device)
    method = config["method"].lower()
    if config.get("task") == "diffusion-unsup":
        return _diffusion(config, model_config, seed).to(dev)
    nc, n_in = int(config["num_classes"]), int(config["num_channels"])
    kw = dict(dtype=compute_dtype(config), generator=torch.Generator().manual_seed(seed))
    backbone = model_config.get("backbone")
    if method == "unet":
        from .unet import UNet

        model = UNet(in_channels=n_in, num_classes=nc, backbone=backbone or "resnet18",
                     conv_bn_kernel=bool(config.get("conv_bn_kernel", False)),
                     dw_kernel=bool(config.get("dw_kernel", False)), **kw)
    elif method in ("unetplusplus", "unet++"):
        from .unet import UNetPlusPlus

        model = UNetPlusPlus(n_in, nc, backbone=backbone or "resnet18", **kw)
    elif method == "deeplabv3":
        from .unet import DeepLabV3Plus

        model = DeepLabV3Plus(n_in, nc, backbone=backbone or "resnet18", **kw)
    elif method == "upernet":
        from .upernet import UperNet

        model = UperNet(n_in, nc, backbone=backbone or "convnext_tiny",
                        backbone_spec=model_config.get("backbone_spec"),
                        image_size=min(224, int(config.get("synthetic_patch_size", 224) or 224)),
                        **kw)
    elif method == "finetune":
        model = _finetuner(config, n_in, nc, **kw)
    else:
        raise NotImplementedError(f"segmentation method {method!r} is not supported")
    return model.to(dev)


def _diffusion(config: dict, model_config: dict, seed: int):
    """The diffusion task's model, whatever the method (JAX
    ``factory.py:28-40``): ``GaussianDiffusion`` around a 2-channel
    ``DDPMUnet`` of the model config's ``dim``, ``dim_mults`` and
    ``timesteps`` (defaults 64, (1, 2, 4, 8), 1000), with the L1 loss."""
    from .diffusion import DDPMUnet, GaussianDiffusion

    mc = model_config or {}
    unet = DDPMUnet(dim=int(mc.get("dim", 64)), dim_mults=tuple(mc.get("dim_mults", (1, 2, 4, 8))),
                    channels=2, dtype=compute_dtype(config),
                    generator=torch.Generator().manual_seed(seed))
    return GaussianDiffusion(unet, timesteps=int(mc.get("timesteps", 1000)), loss_type="l1")


def _finetuner(config: dict, n_in: int, nc: int, dtype: torch.dtype,
               generator: torch.Generator):
    from .finetuner import FinetunerSegmentation
    from .vit import ViT

    size = int(config.get("image_size", 224))
    patch = int(config.get("finetuning_patch_size", 16))
    data = config.get("synthetic_patch_size")
    if data is not None and int(data) != size:
        raise ValueError(f"finetune builds its ViT for {size}x{size} patches (image_size) and "
                         f"the synthetic patches are {data}x{data} (synthetic_patch_size): "
                         "set the two keys to one value")
    encoder = ViT(image_size=size, patch_size=patch, dim=int(config.get("dim", 1024)),
                  depth=int(config.get("depth", 24)), heads=int(config.get("heads", 16)),
                  mlp_dim=int(config.get("mlp_dim", 2048)), channels=n_in, pool="cls",
                  dtype=dtype, generator=generator)
    head = "mlp" if config.get("mlp") else ("decoder" if config.get("decoder") else "linear")
    return FinetunerSegmentation(encoder, num_classes=nc, head=head,
                                 finetuning_patch_size=patch, image_size=size, dtype=dtype,
                                 generator=generator)


def initialize_cd_model(config: dict, model_config: dict, phase: str = "train",
                        device: str | torch.device | None = "cuda", seed: int = 0):
    """The change-detection model on ``device`` (JAX ``initialize_cd_model``,
    ``factory.py:87-162``), f32 parameters from a seeded ``torch.Generator``;
    ``num_channels`` is the channels of one frame. SNUNet's ``remat``
    defaults on at batch >= 64 unless the config sets it, as JAX's does; the
    other methods' ``remat`` is the train step's whole-forward form
    (``training/steps.py``). The model-config keys and their defaults are
    the JAX factory's (``factory.py:91-162``). TransUNet-CD's position
    table is sized for the patch side the JAX engine initialises at,
    min(224, ``synthetic_patch_size``)."""
    del phase
    dev = resolve_device(device)
    method = config["method"].lower()
    nc = int(config["num_classes"])
    n_in = int(config["num_channels"])
    kw = dict(dtype=compute_dtype(config), generator=torch.Generator().manual_seed(seed))
    if method in ("siam-conc", "siam-diff"):
        from .siam import SiamUnetConc, SiamUnetDiff

        cls = SiamUnetConc if method == "siam-conc" else SiamUnetDiff
        model = cls(n_in, nc, **kw)
    elif method == "snunet":
        from .snunet import SNUNetECAM

        for key in ("snunet_phase", "snunet_dts_up"):
            if config.get(key):
                raise NotImplementedError(
                    f"{key} is an exact TPU reparameterization of SNUNet's function and is "
                    "not ported (ROADMAP.md, Not to port)")
        remat = config["remat"] if "remat" in config else int(config.get("batch_size", 0)) >= 64
        model = SNUNetECAM(n_in, nc, base_channel=int(model_config.get("base_channel", 32)),
                           remat=bool(remat),
                           save_bn_stats=bool(config.get("snunet_save_bn_stats", True)), **kw)
    elif method == "bit-cd":
        from .bit_cd import build_bit_cd

        model = build_bit_cd(model_config, n_in, nc, **kw)
    elif method == "hfa-net":
        from .hfanet import HFANet

        model = HFANet(n_in, nc, **kw)
    elif method == "changeformer":
        from .changeformer import ChangeFormerV6

        model = ChangeFormerV6(
            n_in, embed_dim=int(model_config.get("embed_dim", 256)), num_classes=nc,
            decoder_softmax=bool(model_config.get("decoder_softmax", True)),
            tail_chunks=int(model_config.get("tail_chunks", 0)),
            remat_ffn=model_config.get("remat_ffn", "auto"), **kw)
    elif method == "adhr-cdnet":
        from .adhr_cdnet import ADHR

        model = ADHR(n_in, nc, **kw)
    elif method == "transunet-cd":
        from .transunet_cd import TransUNetCD

        model = TransUNetCD(
            n_in, out_channels=int(model_config.get("out_channels", 128)),
            head_num=int(model_config.get("head_num", 4)),
            mlp_dim=int(model_config.get("mlp_dim", 512)),
            block_num=int(model_config.get("block_num", 8)),
            patch_dim=int(model_config.get("patch_dim", 16)), num_classes=nc,
            siamese=bool(model_config.get("siamese", False)),
            img_dim=min(224, int(config.get("synthetic_patch_size", 224) or 224)), **kw)
    else:
        raise NotImplementedError(f"cd method {method!r} is not supported")
    return model.to(dev)


def initialize_recurrent_model(config: dict, model_config: dict, phase: str = "train",
                               device: str | torch.device | None = "cuda", seed: int = 0):
    """The recurrent model on ``device`` (JAX ``initialize_recurrent_model``,
    ``factory.py:165-170``): the ConvLSTM over frames of ``num_channels``
    (one frame's channels), f32 parameters from a seeded
    ``torch.Generator``."""
    del phase, model_config
    dev = resolve_device(device)
    if config["method"] != "convlstm":
        raise NotImplementedError(f"recurrent method {config['method']!r} is not supported")
    from .convlstm import ConvLSTM

    model = ConvLSTM(int(config["num_channels"]), int(config["num_classes"]),
                     dtype=compute_dtype(config), generator=torch.Generator().manual_seed(seed))
    return model.to(dev)


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
