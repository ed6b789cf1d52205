"""HFA-Net, high-frequency attention siamese change detection; counterpart
of ``kurosiwo_tpu/models/hfanet.py``: fixed high-pass banks (the reference's
isotropic Sobel in 8 directions after a 3x3 Gaussian smooth, computed on
the channel sum, ``high_frequency``), HFAB blocks (a mini-UNet spatial
attention mask, then an SE-style channel gate beside the high-pass branch,
fused by a 1x1 conv), a 5-stage siamese encoder (64 ... 1024 channels), 1x1
fusion of the two frames' skips, a decoder with corner-aligned bilinear
upsamples, and a softmax inside the model.

Module names are the flax ones, the auto-names included (``Conv_0``,
``BatchNorm_0``, ``PReLU_0``, ``ConvBNPReLU_3``, ``TorchConvTranspose_1``),
so the bridge stays a path join. The encoder's last stage runs its spatial
attention at 14x14 with the reference's k3/s3/p2/op2 transposed conv, which
fits 224x224 inputs only, as in the JAX model.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batchnorm import BatchNorm
from ..ops.nn import Conv, Dense, PReLU, TorchConvTranspose, max_pool, resize_bilinear

_SOBEL = [
    [[1, math.sqrt(2), 1], [0, 0, 0], [-1, -math.sqrt(2), -1]],
    [[0, 1, math.sqrt(2)], [-1, 0, 1], [-math.sqrt(2), -1, 0]],
    [[-1, 0, 1], [-math.sqrt(2), 0, math.sqrt(2)], [-1, 0, 1]],
    [[math.sqrt(2), 1, 0], [1, 0, -1], [0, -1, -math.sqrt(2)]],
]
_SMOOTH = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]
# the 8 directions: the 4 Sobel kernels, then their negations
_BANK = tuple(_SOBEL) + tuple([[-v for v in row] for row in kd] for kd in _SOBEL)


@functools.lru_cache(maxsize=16)
def _kernels(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(9, 1, 3, 3): the smooth kernel, then the 8 directions, made once per
    dtype and device (a host-to-device copy in every call would wait on the
    card)."""
    return torch.tensor([_SMOOTH, *_BANK], dtype=torch.float64).to(device, dtype)[:, None]


def _conv_const(x: torch.Tensor, i: int) -> torch.Tensor:
    """Single-channel 3x3 SAME conv of (B, H, W, 1) with constant kernel
    ``i`` of :func:`_kernels`."""
    k = _kernels(x.dtype, x.device)[i:i + 1]
    return F.conv2d(x.permute(0, 3, 1, 2), k, padding=1).permute(0, 2, 3, 1)


def high_frequency(x: torch.Tensor, mode: str = "filtering", a: float = 1.0, k: float = 0.5,
                   smooth: bool = True) -> torch.Tensor:
    """The reference's HighFrequencyModule with the JAX package's channel-sum
    factorization (its every (out, in) kernel pair is the same 3x3 kernel,
    so each output channel is that kernel applied to the channel sum; the
    smooth divides by 16 whatever C is). The eight directions are summed
    literally, as the JAX package does, though they cancel pairwise.

    Computed in f32 whatever x's dtype. The JAX package computes it in the
    compute dtype, and its bf16 model has the fault this avoids: in bf16
    the eight directions' gradients do not cancel exactly, and the residue,
    times C, grows through the HFA blocks to gradients 1e13 times the f32
    model's at the first encoder layer, so the first bf16 step's update
    overflows (ROADMAP C18)."""
    dtype, x = x.dtype, x.float()
    c = x.shape[-1]
    s = x.sum(dim=-1, keepdim=True)
    if smooth:
        smoothed = _conv_const(s, 0) / 16.0
        sobel_in = smoothed * c
        base = smoothed.expand(x.shape)
    else:
        sobel_in = s
        base = x
    hf = sum(_conv_const(sobel_in, 1 + i) for i in range(4)) + sum(
        _conv_const(sobel_in, 5 + i) for i in range(4))
    hf = (hf / 8.0).expand(x.shape)
    if mode == "filtering":
        return hf.to(dtype)
    return (a * base + k * hf).to(dtype)


class ConvBNPReLU(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, padding=kernel // 2, bias=True,
                           generator=generator)
        self.BatchNorm_0 = BatchNorm(features)
        self.PReLU_0 = PReLU(features)

    def forward(self, x, dtype):
        return self.PReLU_0(self.BatchNorm_0(self.Conv_0(x, dtype), dtype))


class SpatialAttentionStage(nn.Module):
    """Mini-UNet producing a sigmoid spatial mask; out = x + x * mask."""

    def __init__(self, c: int, last_layer: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        chain = [(c, c // 2), (c // 2, c // 2), (c // 2, c // 4), (c // 4, c // 4),
                 (c // 4, c // 8), (c // 8, c // 8), (c // 16 + c // 4, c // 16),
                 (c // 16, c // 16), (c // 32 + c // 2, c // 32), (c // 32, c // 32)]
        for i, (cin, cout) in enumerate(chain):
            self.add_module(f"ConvBNPReLU_{i}", ConvBNPReLU(cin, cout, generator=g))
        self.ConvBNPReLU_10 = ConvBNPReLU(c // 32, c // 64, kernel=1, generator=g)
        if last_layer:
            self.TorchConvTranspose_0 = TorchConvTranspose(c // 8, c // 16, 3, 3, 2, 2,
                                                           generator=g)
        else:
            self.TorchConvTranspose_0 = TorchConvTranspose(c // 8, c // 16, 3, 2, 1, 1,
                                                           generator=g)
        self.TorchConvTranspose_1 = TorchConvTranspose(c // 16, c // 32, 3, 2, 1, 1,
                                                       generator=g)
        self.Conv_0 = Conv(c // 64, 1, 1, bias=True, generator=g)
        self.BatchNorm_0 = BatchNorm(1)

    def forward(self, x, dtype):
        residual = x
        block = lambda i, y: getattr(self, f"ConvBNPReLU_{i}")(y, dtype)  # noqa: E731
        x = block(1, block(0, x))
        skip1 = x
        x = block(3, block(2, max_pool(x, 2, 2)))
        skip2 = x
        x = block(5, block(4, max_pool(x, 2, 2)))
        x = torch.cat([self.TorchConvTranspose_0(x, dtype), skip2], dim=-1)
        x = block(7, block(6, x))
        x = torch.cat([self.TorchConvTranspose_1(x, dtype), skip1], dim=-1)
        x = block(10, block(9, block(8, x)))
        mask = torch.sigmoid(self.BatchNorm_0(self.Conv_0(x, dtype), dtype))
        return residual + residual * mask


class HighFrequencyEnhancementStage(nn.Module):
    """SE-style channel gate beside the high-pass branch, fused by a 1x1
    conv."""

    def __init__(self, c: int, ratio: float = 0.5, generator: torch.Generator | None = None):
        super().__init__()
        hidden = int(c * ratio)
        self.fc1 = Dense(c, hidden, generator=generator)
        self.PReLU_0 = PReLU(hidden)
        self.fc2 = Dense(hidden, c, generator=generator)
        self.fusion = Conv(2 * c, c, 1, bias=True, generator=generator)

    def forward(self, x, dtype):
        residual = x
        hf = high_frequency(x, mode="filtering", smooth=True)
        g = x.mean(dim=(1, 2))
        g = torch.sigmoid(self.fc2(self.PReLU_0(self.fc1(g, dtype)), dtype))[:, None, None, :]
        out = torch.cat([residual + residual * g, hf.to(g.dtype)], dim=-1)
        return self.fusion(out, dtype)


class HFAB(nn.Module):
    def __init__(self, c: int, last_layer: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.sa = SpatialAttentionStage(c, last_layer, generator=generator)
        self.hf = HighFrequencyEnhancementStage(c, generator=generator)

    def forward(self, x, dtype):
        return self.hf(self.sa(x, dtype), dtype)


class _EncLayer(nn.Module):
    def __init__(self, cin: int, features: int, last_layer: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hfab1 = HFAB(cin, last_layer, generator=generator)
        self.conv1 = ConvBNPReLU(cin, features, generator=generator)
        self.hfab2 = HFAB(features, last_layer, generator=generator)
        self.conv2 = ConvBNPReLU(features, features, generator=generator)

    def forward(self, x, dtype):
        x = self.conv1(self.hfab1(x, dtype), dtype)
        return self.conv2(self.hfab2(x, dtype), dtype)


_WIDTHS = (64, 128, 256, 512, 1024)


class HFAEncoder(nn.Module):
    def __init__(self, in_channels: int, generator: torch.Generator | None = None):
        super().__init__()
        self.pre_treat = Conv(in_channels, 64, 1, bias=True, generator=generator)
        cin = 64
        for i, feat in enumerate(_WIDTHS):
            self.add_module(f"layer_{i + 1}", _EncLayer(cin, feat, last_layer=i == 4,
                                                        generator=generator))
            cin = feat

    def forward(self, x, dtype):
        x = high_frequency(x, mode="high_boost_filtering", a=1.0, k=0.5, smooth=True)
        x = self.pre_treat(x, dtype)
        skips = []
        for i in range(5):
            x = getattr(self, f"layer_{i + 1}")(x, dtype)
            if i < 4:
                skips.append(x)
                x = max_pool(x, 2, 2)
        return x, skips


class _UpBlock(nn.Module):
    def __init__(self, cin: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.reduce = Conv(cin, features, 1, bias=True, generator=g)
        self.conv1 = ConvBNPReLU(2 * features, features, generator=g)
        self.hfab1 = HFAB(features, generator=g)
        self.conv2 = ConvBNPReLU(features, features, generator=g)
        self.hfab2 = HFAB(features, generator=g)

    def forward(self, x, skip, dtype):
        x = self.reduce(x, dtype)
        x = resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), align_corners=True)
        x = torch.cat([x, skip], dim=-1)
        x = self.hfab1(self.conv1(x, dtype), dtype)
        return self.hfab2(self.conv2(x, dtype), dtype)


class HFANet(nn.Module):
    """``forward(x1, x2)``: two NHWC 224x224 frames in, (B, 224, 224,
    num_classes) f32 softmax probabilities out."""

    def __init__(self, in_channels: int, num_classes: int = 3,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.encoder = HFAEncoder(in_channels, generator=g)
        for i, c in enumerate(_WIDTHS[:4]):
            self.add_module(f"skip_fusion_{i + 1}", Conv(2 * c, c, 1, bias=True, generator=g))
        self.bottom_fusion = Conv(2048, 1024, 1, bias=True, generator=g)
        cin = 1024
        for i, feat in enumerate((512, 256, 128, 64)):
            self.add_module(f"up_{i + 1}", _UpBlock(cin, feat, generator=g))
            cin = feat
        self.out1 = ConvBNPReLU(64, 32, generator=g)
        self.out2 = ConvBNPReLU(32, 32, generator=g)
        self.head = Conv(32, num_classes, 1, bias=True, generator=g)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        b1, s1 = self.encoder(x1, dt)
        b2, s2 = self.encoder(x2, dt)
        fused = [getattr(self, f"skip_fusion_{i + 1}")(torch.cat([a, b], dim=-1), dt)
                 for i, (a, b) in enumerate(zip(s1, s2))]
        x = self.bottom_fusion(torch.cat([b1, b2], dim=-1), dt)
        for i in range(4):
            x = getattr(self, f"up_{i + 1}")(x, fused[3 - i], dt)
        x = self.out2(self.out1(x, dt), dt)
        return torch.softmax(self.head(x, dt).float(), dim=-1)
