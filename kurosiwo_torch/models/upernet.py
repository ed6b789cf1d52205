"""UperNet with a ConvNeXt or Swin backbone; counterpart of
``kurosiwo_tpu/models/upernet.py`` (``ConvNeXtBlock``, ``ConvNeXt``,
``PSPModule``, ``UperNetHead``, ``UperNet``, ``:24-150``).

ConvNeXt: a 4x4/s4 stem, 2x2/s2 downsamples, blocks of a 7x7 depthwise
conv, LayerNorm, a 4x MLP with exact GELU and the f32 layer scale ``gamma``
(cast to the activation's dtype), a LayerNorm on each stage's output. Its
LayerNorms are flax ``nn.LayerNorm`` (eps 1e-6): f32 statistics, one
rounding to the compute dtype, the function of ``ops/layernorm.LayerNorm``.
The head: 1x1 laterals, PSP (bins 1, 2, 3, 6 through ``adaptive_avg_pool``)
on the deepest map, a top-down sum, 3x3 FPN convs, the four levels resized
to /4 and fused by a 3x3, a 1x1 classifier; the logits resized to the
input in f32. Every BatchNorm of the head runs through B3. The resizes are
``resize_linear``, ``jax.image.resize``'s "linear" that the JAX
``resize_bilinear`` calls: upsampling everywhere at 224x224, and
antialiased where a PSP bin exceeds a small map's side (6 bins on a 2x2
map at 64x64).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.layernorm import LayerNorm
from ..ops.nn import Conv, ConvBNAct, Dense, adaptive_avg_pool, resize_linear

CONVNEXT_SPECS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
}
SWIN_SPECS = {
    "swin_tiny": ((2, 2, 6, 2), 96, (3, 6, 12, 24)),
    "swin_small": ((2, 2, 18, 2), 96, (3, 6, 12, 24)),
    "swin_base": ((2, 2, 18, 2), 128, (4, 8, 16, 32)),
}


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dwconv = Conv(dim, dim, 7, padding=3, bias=True, groups=dim, generator=generator)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Dense(dim, 4 * dim, generator=generator)
        self.pwconv2 = Dense(4 * dim, dim, generator=generator)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.norm(self.dwconv(x, dtype), dtype)
        y = self.pwconv2(torch.nn.functional.gelu(self.pwconv1(y, dtype)), dtype)
        return x + y * self.gamma.to(y.dtype)


class ConvNeXt(nn.Module):
    """Four stages, strides 4, 8, 16, 32; returns each stage's normed map.
    ``spec`` overrides (depths, dims)."""

    def __init__(self, in_channels: int, backbone: str = "convnext_tiny", spec=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        depths, dims = spec or CONVNEXT_SPECS[backbone]
        g = generator
        self.depths = tuple(depths)
        self.stem = Conv(in_channels, dims[0], 4, 4, padding="SAME", bias=True, generator=g)
        self.stem_norm = LayerNorm(dims[0], eps=1e-6)
        for s in range(4):
            if s > 0:
                self.add_module(f"down_norm{s}", LayerNorm(dims[s - 1], eps=1e-6))
                self.add_module(f"down{s}", Conv(dims[s - 1], dims[s], 2, 2, padding="SAME",
                                                 bias=True, generator=g))
            for b in range(depths[s]):
                self.add_module(f"stage{s}_block{b}", ConvNeXtBlock(dims[s], generator=g))
            self.add_module(f"out_norm{s}", LayerNorm(dims[s], eps=1e-6))
        self.channels = list(dims)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> list[torch.Tensor]:
        feats = []
        for s in range(4):
            if s == 0:
                x = self.stem_norm(self.stem(x, dtype), dtype)
            else:
                x = getattr(self, f"down{s}")(getattr(self, f"down_norm{s}")(x, dtype), dtype)
            for b in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{b}")(x, dtype)
            feats.append(getattr(self, f"out_norm{s}")(x, dtype))
        return feats


class PSPModule(nn.Module):
    """The input, and for each bin its adaptive average pool through a 1x1
    ``branch{i}`` resized back; concatenated and fused by the 3x3
    ``bottleneck``."""

    def __init__(self, cin: int, features: int, bins: Sequence[int] = (1, 2, 3, 6),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.bins = tuple(bins)
        for i in range(len(self.bins)):
            self.add_module(f"branch{i}", ConvBNAct(cin, features, 1, padding=0,
                                                    generator=generator))
        self.bottleneck = ConvBNAct(cin + features * len(self.bins), features, 3,
                                    generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h, w = x.shape[1:3]
        outs = [x.to(dtype)]
        for i, b in enumerate(self.bins):
            pooled = getattr(self, f"branch{i}")(adaptive_avg_pool(x, (b, b)), dtype)
            outs.append(resize_linear(pooled, (h, w)))
        return self.bottleneck(torch.cat(outs, dim=-1), dtype)


class UperNetHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], channels: int = 512, num_classes: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.levels = len(in_channels)
        for i, c in enumerate(in_channels[:-1]):
            self.add_module(f"lateral{i}", ConvBNAct(c, channels, 1, padding=0, generator=g))
        self.psp = PSPModule(in_channels[-1], channels, generator=g)
        for i in range(self.levels - 1):
            self.add_module(f"fpn_conv{i}", ConvBNAct(channels, channels, 3, generator=g))
        self.fpn_bottleneck = ConvBNAct(channels * self.levels, channels, 3, generator=g)
        self.classifier = Conv(channels, num_classes, 1, bias=True, generator=g)

    def forward(self, feats: list[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        laterals = [getattr(self, f"lateral{i}")(f, dtype) for i, f in enumerate(feats[:-1])]
        laterals.append(self.psp(feats[-1], dtype))
        for i in range(self.levels - 1, 0, -1):  # top-down
            laterals[i - 1] = laterals[i - 1] + resize_linear(
                laterals[i], tuple(laterals[i - 1].shape[1:3]))
        outs = [getattr(self, f"fpn_conv{i}")(lat, dtype)
                for i, lat in enumerate(laterals[:-1])]
        outs.append(laterals[-1])
        size = tuple(outs[0].shape[1:3])
        outs = [o if tuple(o.shape[1:3]) == size else resize_linear(o, size) for o in outs]
        return self.classifier(self.fpn_bottleneck(torch.cat(outs, dim=-1), dtype), dtype)


class UperNet(nn.Module):
    """NHWC in, (B, H, W, num_classes) f32 logits out. ``backbone`` is one of
    ``CONVNEXT_SPECS`` or ``SWIN_SPECS``; ``backbone_spec`` overrides its
    size (any name starting with ``convnext`` or ``swin``). A Swin backbone
    is built for inputs of side ``image_size``."""

    def __init__(self, in_channels: int, num_classes: int = 3,
                 backbone: str = "convnext_tiny", channels: int = 512,
                 dtype: torch.dtype = torch.float32, backbone_spec=None,
                 image_size: int = 224, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        if backbone in CONVNEXT_SPECS or (backbone_spec and backbone.startswith("convnext")):
            self.backbone = ConvNeXt(in_channels, backbone, backbone_spec, generator=generator)
        elif backbone in SWIN_SPECS or (backbone_spec and backbone.startswith("swin")):
            from .swin import SwinTransformer

            self.backbone = SwinTransformer(in_channels, backbone, spec=backbone_spec,
                                            image_size=image_size, generator=generator)
        else:
            raise NotImplementedError(f"UperNet backbone {backbone!r}: one of "
                                      f"{sorted(CONVNEXT_SPECS) + sorted(SWIN_SPECS)}")
        self.decode_head = UperNetHead(self.backbone.channels, channels, num_classes,
                                       generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        logits = self.decode_head(self.backbone(x, dt), dt)
        return resize_linear(logits, tuple(x.shape[1:3])).float()
