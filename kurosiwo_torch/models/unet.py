"""UNet with a ResNet encoder (smp.Unet topology); counterpart of
``kurosiwo_tpu/models/unet.py::UNet`` with the standard decoder
(``unet.py:76-81``).

The JAX ``phase_finale``, ``fold_up`` and ``phase_level4`` are exact TPU
reparameterizations of this same function from the same parameters and are
not ported; the tests hold this model against the JAX one with
``phase_finale`` on and off.

Dtype policy: f32 parameters; every convolution casts its weight and input
to the compute dtype (bf16 by default), and the logits come out in it. The
compute dtype can be overridden per call: ``model(x, dtype=torch.float32)``
is the f32 twin that the eval step runs on the same parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.nn import Conv, ConvBNAct, upsample2x
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
