"""ResNet encoder (NHWC); counterpart of ``kurosiwo_tpu/models/resnet.py``:
the BasicBlock backbones (resnet18, resnet34) and the Bottleneck ones
(resnet50, resnet101) of the UNet, UNet++ and DeepLabV3+ encoders, and
BiT-CD's dilated trunk. Submodules carry the flax names (``stem``,
``layer1_0``, ``ConvBNAct_0``, ...)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.nn import ConvBNAct, max_pool



class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False,
                 generator: torch.Generator | None = None, dilation: int = 1, **routes: bool):
        super().__init__()
        g = generator
        self.ConvBNAct_0 = ConvBNAct(cin, features, 3, stride, generator=g, dilation=dilation,
                                     **routes)
        self.ConvBNAct_1 = ConvBNAct(features, features, 3, 1, act=False, generator=g,
                                     dilation=dilation, **routes)
        self.ConvBNAct_2 = (
            ConvBNAct(cin, features, 1, stride, act=False, padding=0, generator=g)
            if downsample else None
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.ConvBNAct_1(self.ConvBNAct_0(x, dtype), dtype)
        identity = self.ConvBNAct_2(x, dtype) if self.ConvBNAct_2 is not None else x
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 to 4x ``features``, the
    projection ``ConvBNAct_3`` on the identity where ``downsample``."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False,
                 generator: torch.Generator | None = None, dilation: int = 1, **routes: bool):
        super().__init__()
        g = generator
        out = features * self.expansion
        self.ConvBNAct_0 = ConvBNAct(cin, features, 1, padding=0, generator=g)
        self.ConvBNAct_1 = ConvBNAct(features, features, 3, stride, generator=g,
                                     dilation=dilation, **routes)
        self.ConvBNAct_2 = ConvBNAct(features, out, 1, act=False, padding=0, generator=g)
        self.ConvBNAct_3 = (
            ConvBNAct(cin, out, 1, stride, act=False, padding=0, generator=g)
            if downsample else None
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x, dtype), dtype), dtype)
        identity = self.ConvBNAct_3(x, dtype) if self.ConvBNAct_3 is not None else x
        return torch.relu(y + identity)


RESNET_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
}


class ResNetEncoder(nn.Module):
    """5-stage pyramid: [x, s1(/2), s2(/4), s3(/8), s4(/16), s5(/32)].
    ``routes`` (``conv_bn_kernel``, ``dw_kernel``) go to every block's
    ``ConvBNAct``, whose gates decide which conv takes them.

    ``dilations`` (stages 3..5) replaces a stage's stride with dilation
    (torchvision's replace_stride_with_dilation). ``clamp_basic_dilation``
    is BiT-CD's vendored torchvision quirk (``resnet.py:74-96``): its
    BasicBlock clamps a dilation above 1 back to 1, so those stages become
    stride-1 convs that are not dilated; a Bottleneck keeps its dilation.
    ``channels`` lists the pyramid's widths, 4x the stage width for a
    Bottleneck trunk."""

    def __init__(self, in_channels: int, backbone: str = "resnet18", width: int = 64,
                 generator: torch.Generator | None = None,
                 dilations: tuple[bool, bool, bool] = (False, False, False),
                 clamp_basic_dilation: bool = False, **routes: bool):
        super().__init__()
        if backbone not in RESNET_SPECS:
            raise NotImplementedError(f"backbone {backbone!r} is not supported; "
                                      f"supported: {sorted(RESNET_SPECS)}")
        block, depths = RESNET_SPECS[backbone]
        self.stem = ConvBNAct(in_channels, width, 7, 2, padding=3, generator=generator)
        self.blocks = []
        self.channels = [in_channels, width]
        cin = width
        dilation = 1
        for stage, depth in enumerate(depths):
            features = width * 2**stage
            stride = 1 if stage == 0 else 2
            if stage > 0 and dilations[stage - 1]:
                dilation *= stride
                stride = 1
            block_dilation = (1 if clamp_basic_dilation and block is BasicBlock
                              else dilation)
            out = features * block.expansion
            for i in range(depth):
                name = f"layer{stage + 1}_{i}"
                ds = i == 0 and (stride != 1 or cin != out)
                self.add_module(name, block(cin, features, stride if i == 0 else 1, ds,
                                            generator=generator, dilation=block_dilation,
                                            **routes))
                self.blocks.append((stage, name))
                cin = out
            self.channels.append(out)

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
