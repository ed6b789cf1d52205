"""Building blocks of the port's models; counterpart of the parts of
``kurosiwo_tpu/ops/nn.py`` that UNet-ResNet uses, plus flax's ``Dense``.

Public tensors are NHWC, like the JAX package. A convolution runs on the
zero-copy NCHW view ``x.permute(0, 3, 1, 2)`` of an NHWC tensor, which is a
``channels_last`` tensor that cuDNN takes directly, and its output is
permuted back. Convolutions stay library calls: the JAX default path leaves
them to XLA as well.

Mixed precision follows flax's (dtype, param_dtype) pair: parameters are f32
and each convolution casts its weight and input to the compute ``dtype``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .batchnorm import BatchNorm


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator | None = None):
    """flax's default conv init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC: ``weight`` (OIHW, f32), optional ``bias``
    added after the convolution in the compute dtype, as flax adds it."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
                 bias: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        lecun_normal_(self.weight.data, cin * kernel * kernel, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), self.weight.to(dtype),
                     stride=self.stride, padding=self.padding)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` (out, in) f32 (the flax kernel
    transposed), optional ``bias``; input and parameters are cast to the
    compute dtype for the product."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        lecun_normal_(self.weight.data, cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b = self.bias.to(dtype) if self.bias is not None else None
        return F.linear(x.to(dtype), self.weight.to(dtype), b)


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm -> optional ReLU: the default branch of the JAX
    ``ConvBNAct`` (``ops/nn.py:481-498``), with its flax names
    ``Conv_0`` and ``BatchNorm_0``. Padding defaults to k//2 (SAME)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 act: bool = True, padding: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        pad = padding if padding is not None else kernel // 2
        self.Conv_0 = Conv(cin, features, kernel, stride, pad, generator=generator)
        self.BatchNorm_0 = BatchNorm(features)
        self.act = act

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.BatchNorm_0(self.Conv_0(x, dtype), dtype)
        return torch.relu(y) if self.act else y


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pooling on NHWC with XLA's semantics: padding takes -inf."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample on NHWC (broadcast + reshape, as the JAX package)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
