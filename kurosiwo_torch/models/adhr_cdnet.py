"""ADHR-CDNet, attentive differential high-resolution change detection
(Zhang et al., TGRS 2022); counterpart of ``kurosiwo_tpu/models/adhr_cdnet.py``:
a shared stem conv on both frames; per scale, the absolute difference of
the two frames' VGG features concatenated into each new branch and fused by
a 1x1 conv; HRNet-style parallel branches at four resolutions (32, 64, 128,
256 channels) of four residual BasicBlocks each (ReLU after the residual
add); exchange units (1x1 conv + BN + bilinear upsample coarse to fine,
strided 3x3 conv chains fine to coarse, merged by sums); the head's softmax
attention over the four upsampled branches and a softmax inside the model.
``BottleneckN``'s shortcut reuses the main path's last BatchNorm (``bn3``,
run twice a forward), as the reference does.

Module names are the flax ones, the auto-names included (``Conv_0``,
``BatchNorm_0``, ``_ConvBN_2``), so the bridge stays a path join. H and W
must be multiples of 8.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.batchnorm import BatchNorm
from ..ops.nn import Conv, max_pool, resize_bilinear


class _ConvBN(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, stride, kernel // 2, bias=True,
                           generator=generator)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x, dtype):
        return self.BatchNorm_0(self.Conv_0(x, dtype), dtype)


def _conv_bns(module: nn.Module, specs, generator) -> None:
    """Add ``_ConvBN_i`` for each (cin, features, kernel) of ``specs``."""
    for i, (cin, feat, k) in enumerate(specs):
        module.add_module(f"_ConvBN_{i}", _ConvBN(cin, feat, k, generator=generator))


class BasicBlock(nn.Module):
    def __init__(self, features: int, generator: torch.Generator | None = None):
        super().__init__()
        _conv_bns(self, [(features, features, 3)] * 2, generator)

    def forward(self, x, dtype):
        y = torch.relu(self._ConvBN_0(x, dtype))
        return self._ConvBN_1(y, dtype) + x  # the caller applies the ReLU


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, generator: torch.Generator | None = None):
        super().__init__()
        _conv_bns(self, [(cin, mid, 1), (mid, mid, 3), (mid, out, 1)], generator)

    def forward(self, x, dtype):
        y = torch.relu(self._ConvBN_0(x, dtype))
        y = torch.relu(self._ConvBN_1(y, dtype))
        return self._ConvBN_2(y, dtype) + x


class BottleneckN(nn.Module):
    """Bottleneck with a projected shortcut that shares the main path's last
    BatchNorm ``bn3``."""

    def __init__(self, cin: int, mid: int, out: int, generator: torch.Generator | None = None):
        super().__init__()
        self.bn3 = BatchNorm(out)
        _conv_bns(self, [(cin, mid, 1), (mid, mid, 3)], generator)
        self.conv3 = Conv(mid, out, 1, bias=True, generator=generator)
        self.conv1_1 = Conv(cin, out, 1, bias=True, generator=generator)

    def forward(self, x, dtype):
        y = torch.relu(self._ConvBN_0(x, dtype))
        y = torch.relu(self._ConvBN_1(y, dtype))
        y = self.bn3(self.conv3(y, dtype), dtype)
        return y + self.bn3(self.conv1_1(x, dtype), dtype)


class VGGBlock(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, generator: torch.Generator | None = None):
        super().__init__()
        _conv_bns(self, [(cin, mid, 3), (mid, out, 3)], generator)

    def forward(self, x, dtype):
        return torch.relu(self._ConvBN_1(torch.relu(self._ConvBN_0(x, dtype)), dtype))


class _Branch4(nn.Module):
    """Four residual BasicBlocks, each followed by a ReLU."""

    def __init__(self, features: int, generator: torch.Generator | None = None):
        super().__init__()
        for i in range(4):
            self.add_module(f"b{i + 1}", BasicBlock(features, generator=generator))

    def forward(self, x, dtype):
        for i in range(4):
            x = torch.relu(getattr(self, f"b{i + 1}")(x, dtype))
        return x


class _DownChain(nn.Module):
    """Strided 3x3 conv + BN steps, ReLU between them (fine to coarse)."""

    def __init__(self, cin: int, channels: tuple, generator: torch.Generator | None = None):
        super().__init__()
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"d{i}", _ConvBN(cin, ch, 3, 2, generator=generator))
            cin = ch

    def forward(self, x, dtype):
        for i in range(self.n):
            x = getattr(self, f"d{i}")(x, dtype)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


class _UpLink(nn.Module):
    """1x1 conv + BN + bilinear upsample (coarse to fine)."""

    def __init__(self, cin: int, features: int, scale: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.scale = scale
        self._ConvBN_0 = _ConvBN(cin, features, 1, generator=generator)

    def forward(self, x, dtype):
        x = self._ConvBN_0(x, dtype)
        return resize_bilinear(x, (x.shape[1] * self.scale, x.shape[2] * self.scale))


# (name, input channels, output channels or chain, scale) of the exchange
# units of parts two and three, and of the head's upsamples
_UP = {"t2_2to1": (64, 32, 2), "t3_2to1": (64, 32, 2), "t3_3to1": (128, 32, 4),
       "t3_3to2": (128, 64, 2), "f2": (64, 32, 2), "f3": (128, 32, 4), "f4": (256, 32, 8)}
_DOWN = {"t2_1to2": (32, (64,)), "t2_1to3": (32, (64, 128)), "t2_2to3": (64, (128,)),
         "t3_1to2": (32, (64,)), "t3_1to3": (32, (64, 128)), "t3_2to3": (64, (128,)),
         "t3_1to4": (32, (64, 128, 256)), "t3_2to4": (64, (128, 256)), "t3_3to4": (128, (256,))}
_BRANCHES = {2: (32, 64), 3: (32, 64, 128), 4: (32, 64, 128, 256)}


class ADHR(nn.Module):
    """``forward(x, y)``: two NHWC frames in, (B, H, W, num_classes) f32
    softmax probabilities out."""

    def __init__(self, in_channels: int, num_classes: int = 3,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.conv0_0 = Conv(in_channels, 32, 3, padding=1, bias=True, generator=g)
        self.conv0 = Conv(2 * in_channels, 32, 3, padding=1, bias=True, generator=g)
        self.bn0 = BatchNorm(64)
        self.conv1_1_1 = BottleneckN(64, 64, 256, generator=g)
        for i in (2, 3, 4):
            self.add_module(f"conv1_1_{i}", Bottleneck(256, 64, 256, generator=g))
        self.trans1_1 = _ConvBN(256, 32, 3, 1, generator=g)
        self.trans1_2 = _ConvBN(256, 64, 3, 2, generator=g)
        for name, cin, ch in (("conv2", 32, 64), ("conv3", 64, 128), ("conv4", 128, 256)):
            self.add_module(name, VGGBlock(cin, ch, ch, generator=g))
        for name, ch in (("c2", 64), ("c3", 128), ("c4", 256)):
            self.add_module(name, Conv(2 * ch, ch, 1, bias=True, generator=g))
        for stage, widths in _BRANCHES.items():
            for i, ch in enumerate(widths):
                self.add_module(f"stage{stage}_b{i + 1}", _Branch4(ch, generator=g))
        for name, (cin, ch, scale) in _UP.items():
            self.add_module(name, _UpLink(cin, ch, scale, generator=g))
        for name, (cin, chain) in _DOWN.items():
            self.add_module(name, _DownChain(cin, chain, generator=g))
        self.attention1 = Conv(128, 512, 3, padding=1, bias=True, generator=g)
        self.attention2 = Conv(512, 4, 1, bias=True, generator=g)
        self.final = Conv(32, num_classes, 1, bias=True, generator=g)

    def _stage(self, stage: int, branches: list, dt) -> list:
        return [getattr(self, f"stage{stage}_b{i + 1}")(b, dt) for i, b in enumerate(branches)]

    def forward(self, x: torch.Tensor, y: torch.Tensor, dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        m = lambda name, t: getattr(self, name)(t, dt)  # noqa: E731
        x1s, y1s = self.conv0_0(x, dt), self.conv0_0(y, dt)
        d1 = torch.abs(x1s - y1s)
        fused = self.conv0(torch.cat([x, y], dim=-1), dt)
        h = torch.relu(self.bn0(torch.cat([d1, fused], dim=-1), dt))

        # part one: four bottlenecks at full resolution (64 -> 256 channels)
        h = torch.relu(self.conv1_1_1(h, dt))
        for i in (2, 3, 4):
            h = torch.relu(m(f"conv1_1_{i}", h))
        b1 = torch.relu(self.trans1_1(h, dt))
        b2 = torch.relu(self.trans1_2(h, dt))

        # the differential stream (a VGG block shared by the frames), level 2
        x2s, y2s = m("conv2", max_pool(x1s, 2, 2)), m("conv2", max_pool(y1s, 2, 2))
        b2 = self.c2(torch.cat([b2, torch.abs(x2s - y2s)], dim=-1), dt)

        # part two
        b1, b2 = self._stage(2, [b1, b2], dt)
        n1 = torch.relu(m("t2_2to1", b2) + b1)
        n2 = torch.relu(m("t2_1to2", b1) + b2)
        n3 = torch.relu(m("t2_1to3", b1) + m("t2_2to3", b2))
        b1, b2, b3 = n1, n2, n3

        x3s, y3s = m("conv3", max_pool(x2s, 2, 2)), m("conv3", max_pool(y2s, 2, 2))
        b3 = self.c3(torch.cat([b3, torch.abs(x3s - y3s)], dim=-1), dt)

        # part three
        b1, b2, b3 = self._stage(3, [b1, b2, b3], dt)
        n1 = torch.relu(b1 + m("t3_2to1", b2) + m("t3_3to1", b3))
        n2 = torch.relu(m("t3_1to2", b1) + b2 + m("t3_3to2", b3))
        n3 = torch.relu(b3 + m("t3_1to3", b1) + m("t3_2to3", b2))
        n4 = torch.relu(m("t3_1to4", b1) + m("t3_2to4", b2) + m("t3_3to4", b3))
        b1, b2, b3, b4 = n1, n2, n3, n4

        x4s, y4s = m("conv4", max_pool(x3s, 2, 2)), m("conv4", max_pool(y3s, 2, 2))
        b4 = self.c4(torch.cat([b4, torch.abs(x4s - y4s)], dim=-1), dt)

        # part four, then the head
        b1, b2, b3, b4 = self._stage(4, [b1, b2, b3, b4], dt)
        f = [b1, m("f2", b2), m("f3", b3), m("f4", b4)]
        att = self.attention2(self.attention1(torch.cat(f, dim=-1), dt), dt)
        w = torch.softmax(att.float(), dim=-1)
        out1 = (f[0].float() * w[..., 0:1] + f[1].float() * w[..., 1:2]
                + f[2].float() * w[..., 2:3] + f[3].float() * w[..., 3:4])
        return torch.softmax(self.final(out1, torch.float32), dim=-1)
