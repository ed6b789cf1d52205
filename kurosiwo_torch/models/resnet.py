"""ResNet encoder (NHWC); counterpart of ``kurosiwo_tpu/models/resnet.py``
for the BasicBlock backbones (resnet18, resnet34) the UNet uses. Submodules
carry the flax names (``stem``, ``layer1_0``, ``ConvBNAct_0``, ...)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.nn import ConvBNAct, max_pool

RESNET_DEPTHS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False,
                 generator: torch.Generator | None = None, **routes: bool):
        super().__init__()
        g = generator
        self.ConvBNAct_0 = ConvBNAct(cin, features, 3, stride, generator=g, **routes)
        self.ConvBNAct_1 = ConvBNAct(features, features, 3, 1, act=False, generator=g, **routes)
        self.ConvBNAct_2 = (
            ConvBNAct(cin, features, 1, stride, act=False, padding=0, generator=g)
            if downsample else None
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.ConvBNAct_1(self.ConvBNAct_0(x, dtype), dtype)
        identity = self.ConvBNAct_2(x, dtype) if self.ConvBNAct_2 is not None else x
        return torch.relu(y + identity)


class ResNetEncoder(nn.Module):
    """5-stage pyramid: [x, s1(/2), s2(/4), s3(/8), s4(/16), s5(/32)].
    ``routes`` (``conv_bn_kernel``, ``dw_kernel``) go to every block's
    ``ConvBNAct``, whose gates decide which conv takes them."""

    def __init__(self, in_channels: int, backbone: str = "resnet18", width: int = 64,
                 generator: torch.Generator | None = None, **routes: bool):
        super().__init__()
        if backbone not in RESNET_DEPTHS:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported yet (ROADMAP.md, A5); "
                f"ported: {sorted(RESNET_DEPTHS)}")
        self.stem = ConvBNAct(in_channels, width, 7, 2, padding=3, generator=generator)
        self.blocks = []
        self.channels = [in_channels, width]
        cin = width
        for stage, depth in enumerate(RESNET_DEPTHS[backbone]):
            features = width * 2**stage
            stride = 1 if stage == 0 else 2
            for i in range(depth):
                name = f"layer{stage + 1}_{i}"
                ds = i == 0 and (stride != 1 or cin != features)
                self.add_module(name, BasicBlock(cin, features, stride if i == 0 else 1, ds,
                                                 generator=generator, **routes))
                self.blocks.append((stage, name))
                cin = features
            self.channels.append(features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> list[torch.Tensor]:
        feats = [x]
        y = self.stem(x, dtype)
        feats.append(y)
        y = max_pool(y, 3, 2, padding=1)
        for i, (stage, name) in enumerate(self.blocks):
            y = getattr(self, name)(y, dtype)
            if i + 1 == len(self.blocks) or self.blocks[i + 1][0] != stage:
                feats.append(y)
        return feats
