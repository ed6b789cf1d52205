"""Building blocks of the port's models; counterpart of the parts of
``kurosiwo_tpu/ops/nn.py`` that UNet-ResNet uses, plus flax's ``Dense``.

Public tensors are NHWC, like the JAX package. A convolution runs on the
zero-copy NCHW view ``x.permute(0, 3, 1, 2)`` of an NHWC tensor, which is a
``channels_last`` tensor that cuDNN takes directly, and its output is
permuted back. Convolutions are library calls, as the JAX default path
leaves them to XLA, except where ``ConvBNAct``'s opt-in kernel routes take
them.

Mixed precision follows flax's (dtype, param_dtype) pair: parameters are f32
and each convolution casts its weight and input to the compute ``dtype``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .batchnorm import BatchNorm
from .conv_bn import conv3x3_bn
from .conv_dw import conv3x3_pdw, pick_batch_block


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
    """Conv -> BatchNorm -> optional ReLU, the JAX ``ConvBNAct`` with its flax
    names ``Conv_0`` and ``BatchNorm_0``. Padding defaults to k//2 (SAME).

    Its default branch (``ops/nn.py:481-498``) is the library conv and the
    pair-sum BatchNorm. Two opt-in routes, the counterparts of
    ``KUROSIWO_PALLAS_CONV`` and ``KUROSIWO_PALLAS_DW``, take a train-mode
    3x3 stride-1 conv with default padding and 128-multiple channels, with
    the JAX package's gates, tested in its order (``ops/nn.py:425-480``):
      * ``conv_bn_kernel``, for min(Cin, Cout) >= 256: the conv and its BN
        statistics in one pass of the B6 kernel (``ops/conv_bn.conv3x3_bn``);
      * ``dw_kernel``, for min(H, W) >= 6 and a non-zero
        ``pick_batch_block``: the conv's weight gradient by the B7 kernel
        (``ops/conv_dw.conv3x3_pdw``), then the default BatchNorm.
    Both use the same parameters and buffers as the default branch, and
    eval takes neither."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 act: bool = True, padding: int | None = None,
                 generator: torch.Generator | None = None, conv_bn_kernel: bool = False,
                 dw_kernel: bool = False):
        super().__init__()
        pad = padding if padding is not None else kernel // 2
        self.Conv_0 = Conv(cin, features, kernel, stride, pad, generator=generator)
        self.BatchNorm_0 = BatchNorm(features)
        self.act = act
        routable = (kernel == 3 and stride == 1 and padding is None
                    and cin % 128 == 0 and features % 128 == 0)
        self.conv_bn_kernel = conv_bn_kernel and routable and min(cin, features) >= 256
        self.dw_kernel = dw_kernel and routable

    def _takes_dw_route(self, x: torch.Tensor, dtype: torch.dtype) -> bool:
        b, h, w, cin = x.shape
        return self.dw_kernel and min(h, w) >= 6 and bool(pick_batch_block(
            b, h, w, cin, self.Conv_0.weight.shape[0], itemsize=dtype.itemsize))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.training and self.conv_bn_kernel:
            bn = self.BatchNorm_0
            # the HWIO view of the f32 parameter; conv3x3_bn casts it to dtype
            y, mean, var = conv3x3_bn(x.to(dtype), self.Conv_0.weight.permute(2, 3, 1, 0),
                                      bn.scale, bn.bias, bn.eps)
            bn.update_running(mean, var)
        elif self.training and self._takes_dw_route(x, dtype):
            # the weight cast before the route, as the JAX package passes it
            # (nn.py:473): dW is rounded to dtype, then to the f32 parameter
            w = self.Conv_0.weight.to(dtype).permute(2, 3, 1, 0)
            y = self.BatchNorm_0(conv3x3_pdw(x.to(dtype), w), dtype)
        else:
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
