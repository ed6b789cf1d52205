"""UNet, UNet++ and DeepLabV3+ with a ResNet encoder (the smp topologies);
counterpart of ``kurosiwo_tpu/models/unet.py``: ``UNet`` with the standard
decoder (``unet.py:76-81``), ``UNetPlusPlus`` (``:209-243``), ``ASPP`` and
``DeepLabV3Plus`` (``:246-290``).

The JAX ``phase_finale``, ``fold_up`` and ``phase_level4`` are exact TPU
reparameterizations of these same functions from the same parameters and
are not ported; the tests hold the UNet against the JAX one with
``phase_finale`` on and off, and UNet++ with ``fold_up`` on and off.

Dtype policy: f32 parameters; every convolution casts its weight and input
to the compute dtype (bf16 by default). The UNet's logits come out in it,
UNet++'s and DeepLabV3+'s in f32, as the JAX models return them. The
compute dtype can be overridden per call: ``model(x, dtype=torch.float32)``
is the f32 twin that the eval step runs on the same parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.nn import Conv, ConvBNAct, global_avg_pool, resize_bilinear, upsample2x
from .resnet import ResNetEncoder


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, skip_ch: int, features: int,
                 generator: torch.Generator | None = None, **routes: bool):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(cin + skip_ch, features, 3, generator=generator, **routes)
        self.ConvBNAct_1 = ConvBNAct(features, features, 3, generator=generator, **routes)

    def forward(self, x, skip, dtype):
        x = upsample2x(x)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.ConvBNAct_1(self.ConvBNAct_0(x, dtype), dtype)


class UNet(nn.Module):
    """NHWC in, (B, H, W, num_classes) logits out in the compute dtype.

    ``conv_bn_kernel`` and ``dw_kernel`` (off by default, as their JAX
    switches are) open ``ConvBNAct``'s B6 and B7 kernel routes in every
    encoder and decoder block; at 224x224 (and 64x64) a train step routes 8
    convs through B6 (layer3, layer4, DecoderBlock_0) and 5 through B7
    (layer2, DecoderBlock_1)."""

    def __init__(self, in_channels: int, num_classes: int, backbone: str = "resnet18",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None,
                 conv_bn_kernel: bool = False, dw_kernel: bool = False):
        super().__init__()
        self.dtype = dtype
        routes = {"conv_bn_kernel": conv_bn_kernel, "dw_kernel": dw_kernel}
        self.encoder = ResNetEncoder(in_channels, backbone, generator=generator, **routes)
        enc = self.encoder.channels  # [in, /2, /4, /8, /16, /32]
        skips = enc[1:-1][::-1] + [0]  # /16, /8, /4, /2, none
        cin = enc[-1]
        for i, (ch, sk) in enumerate(zip(decoder_channels, skips)):
            self.add_module(f"DecoderBlock_{i}",
                            DecoderBlock(cin, sk, ch, generator=generator, **routes))
            cin = ch
        self.num_blocks = len(decoder_channels)
        self.head = Conv(cin, num_classes, 3, padding=1, bias=True, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        feats = self.encoder(x, dt)
        y = feats[-1]
        skips = feats[1:-1][::-1] + [None]
        for i in range(self.num_blocks):
            y = getattr(self, f"DecoderBlock_{i}")(y, skips[i], dt)
        return self.head(y, dt)


class UNetPlusPlus(nn.Module):
    """smp.UnetPlusPlus: the ResNet encoder's levels /2 to /32 and the nested
    dense grid X[i][j] = DecoderBlock(X[i+1][j-1], skip = cat(X[i][0..j-1]))
    (``dec_{i}_{j}``, ``node_ch`` 32, 64, 128, 256 at level i), then a 2x
    nearest upsample, ``final_block`` and the 3x3 ``head``; f32 logits."""

    node_ch = (32, 64, 128, 256)

    def __init__(self, in_channels: int, num_classes: int, backbone: str = "resnet18",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.encoder = ResNetEncoder(in_channels, backbone, generator=g)
        width = {(i, 0): c for i, c in enumerate(self.encoder.channels[1:])}
        self.levels = len(width)
        for j in range(1, self.levels):
            for i in range(self.levels - j):
                skip = sum(width[(i, k)] for k in range(j))
                self.add_module(f"dec_{i}_{j}", DecoderBlock(width[(i + 1, j - 1)], skip,
                                                             self.node_ch[i], generator=g))
                width[(i, j)] = self.node_ch[i]
        cout = decoder_channels[-1]
        self.final_block = ConvBNAct(width[(0, self.levels - 1)], cout, 3, generator=g)
        self.head = Conv(cout, num_classes, 3, padding=1, bias=True, generator=g)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        enc = self.encoder(x, dt)[1:]  # /2, /4, /8, /16, /32
        grid = {(i, 0): f for i, f in enumerate(enc)}
        for j in range(1, self.levels):
            for i in range(self.levels - j):
                skip = torch.cat([grid[(i, k)].to(dt) for k in range(j)], dim=-1)
                grid[(i, j)] = getattr(self, f"dec_{i}_{j}")(grid[(i + 1, j - 1)], skip, dt)
        y = upsample2x(grid[(0, self.levels - 1)])
        return self.head(self.final_block(y, dt), dt).float()


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, 3x3 branches at
    ``rates``, the global-pool branch (a ConvBNAct over the (B, 1, 1, C) mean,
    bilinearly resized back), concatenated and projected by a 1x1; the flax
    auto-names ``ConvBNAct_0`` to ``ConvBNAct_5`` in that order."""

    def __init__(self, cin: int, features: int = 256, rates: Sequence[int] = (12, 24, 36),
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        convs = [ConvBNAct(cin, features, 1, padding=0, generator=g)]
        convs += [ConvBNAct(cin, features, 3, dilation=r, generator=g) for r in rates]
        convs.append(ConvBNAct(cin, features, 1, padding=0, generator=g))  # the global pool's
        convs.append(ConvBNAct(features * len(convs), features, 1, padding=0, generator=g))
        for i, conv in enumerate(convs):
            self.add_module(f"ConvBNAct_{i}", conv)
        self.branches = len(rates) + 1

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h, w = x.shape[1:3]
        ys = [getattr(self, f"ConvBNAct_{i}")(x, dtype) for i in range(self.branches)]
        gp = getattr(self, f"ConvBNAct_{self.branches}")(global_avg_pool(x), dtype)
        ys.append(resize_bilinear(gp, (h, w)))
        return getattr(self, f"ConvBNAct_{self.branches + 1}")(torch.cat(ys, dim=-1), dtype)


class DeepLabV3Plus(nn.Module):
    """smp.DeepLabV3Plus: an output-stride-16 ResNet trunk (layer4 dilated),
    ``ASPP_0`` on its /16 map, resized to /4 and fused with a 48-channel 1x1
    of the /4 features (``ConvBNAct_0``), two 3x3 ``ConvBNAct``, a 1x1
    ``head`` and a bilinear resize to the input; f32 logits."""

    def __init__(self, in_channels: int, num_classes: int, backbone: str = "resnet18",
                 decoder_channels: int = 256, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.encoder = ResNetEncoder(in_channels, backbone, generator=g,
                                     dilations=(False, False, True))
        enc = self.encoder.channels
        self.ASPP_0 = ASPP(enc[-1], decoder_channels, generator=g)
        self.ConvBNAct_0 = ConvBNAct(enc[2], 48, 1, padding=0, generator=g)
        self.ConvBNAct_1 = ConvBNAct(decoder_channels + 48, decoder_channels, 3, generator=g)
        self.ConvBNAct_2 = ConvBNAct(decoder_channels, decoder_channels, 3, generator=g)
        self.head = Conv(decoder_channels, num_classes, 1, bias=True, generator=g)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        feats = self.encoder(x, dt)
        high = resize_bilinear(self.ASPP_0(feats[-1], dt), tuple(feats[2].shape[1:3]))
        y = torch.cat([high, self.ConvBNAct_0(feats[2], dt)], dim=-1)
        y = self.ConvBNAct_2(self.ConvBNAct_1(y, dt), dt)
        return resize_bilinear(self.head(y, dt), tuple(x.shape[1:3])).float()
