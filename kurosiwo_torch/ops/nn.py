"""Building blocks of the port's models; counterpart of
``kurosiwo_tpu/ops/nn.py`` (every function the models call, and
``avg_pool``), plus flax's ``Dense`` and ``GroupNorm`` and ChangeFormer's ``DropPath``.

Public tensors are NHWC, like the JAX package. A convolution runs on the
zero-copy NCHW view ``x.permute(0, 3, 1, 2)`` of an NHWC tensor, which is a
``channels_last`` tensor that cuDNN takes directly, and its output is
permuted back. Convolutions are library calls, as the JAX default path
leaves them to XLA, except where ``ConvBNAct``'s opt-in kernel routes take
them.

Mixed precision follows flax's (dtype, param_dtype) pair: parameters are f32
and each convolution casts its weight and input to the compute ``dtype``.

The resampling ops (``replication_pad_to``, ``resize_bilinear``,
``resize_linear``, ``resize_nearest``, ``adaptive_avg_pool``) are written in
forms whose backward is deterministic on the card (slices, expands and
gathers of whole rows; two small interpolation- or averaging-matrix
products), since ``F.pad(mode="replicate")``, bilinear ``F.interpolate`` and
``F.adaptive_avg_pool2d`` have no deterministic backward there.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .batchnorm import BatchNorm
from .conv_bn import conv3x3_bn
from .conv_dw import conv3x3_pdw, pick_batch_block
from ..parallel.mesh import (copy_in, draw_rows, full_param, gather_out, reduce_out, shard_of,
                             slice_in)
from .remat import active_region


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator | None = None):
    """flax's default conv init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis, (low, high): the output has
    ceil(size / stride) positions and the odd pixel of padding goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC: ``weight`` (OIHW, f32), optional ``bias``
    added after the convolution in the compute dtype, as flax adds it.
    ``groups`` is flax's ``feature_group_count`` (ChangeFormer's and
    ConvNeXt's depthwise convs: the flax (k, k, 1, C) kernel is the
    (C, 1, k, k) weight). ``padding="SAME"`` is flax's default padding
    (``same_padding``; the patchify convs of ConvNeXt and Swin), zeros
    added before the convolution.

    Under tensor parallelism (``parallel/sharding.py``) a cut ``weight``
    holds this rank's output channels: the conv computes them from the
    whole input and joins them at the output (``gather=False`` leaves this
    rank's channels, which ``ConvBNAct`` normalises); a grouped conv takes
    its weight whole."""

    tp_aware = True

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int | str = 0, bias: bool = False,
                 generator: torch.Generator | None = None, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel, kernel))
        lecun_normal_(self.weight.data, cin // groups * kernel * kernel, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype, gather: bool = True) -> torch.Tensor:
        shard = shard_of(self)
        weight = self.weight
        if shard is not None and self.groups > 1:
            weight, shard = full_param(self, "weight"), None
        if shard is not None:
            x = copy_in(x, shard)
        x = x.to(dtype).permute(0, 3, 1, 2)
        padding = self.padding
        if padding == "SAME":
            k = self.dilation * (self.weight.shape[-1] - 1) + 1
            (top, bottom), (left, right) = (same_padding(n, k, self.stride)
                                            for n in x.shape[2:])
            if top or bottom or left or right:
                x = F.pad(x, (left, right, top, bottom))
            padding = 0
        y = F.conv2d(x, weight.to(dtype), stride=self.stride, padding=padding,
                     dilation=self.dilation, groups=self.groups)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            # a cut conv's channels take the bias's slice before the join, so
            # each is rounded as one process rounds it
            y = y + (slice_in(self.bias, shard, 0) if shard is not None else self.bias).to(dtype)
        return gather_out(y, shard) if shard is not None and gather else y


def _row_sum(y: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype,
             shard) -> torch.Tensor:
    """A row-parallel layer's output: the ranks' f32 partial products summed
    over the model group, the bias added in f32, one rounding to ``dtype``
    (a one-process product accumulates in f32 and rounds once, so partials
    rounded before their sum would add an ulp a layer)."""
    y = reduce_out(y.contiguous(), shard)
    if bias is not None:
        y = y + bias.to(dtype).float()
    return y.to(dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` (out, in) f32 (the flax kernel
    transposed), optional ``bias``; input and parameters are cast to the
    compute dtype for the product.

    Under tensor parallelism a ``weight`` cut on dim 0 (its output
    features) is column-parallel: this rank's features (and bias slice)
    from the whole input, joined at the output unless ``gather=False``. One
    cut on dim 1 (its input features, ``tp_layouts`` of the ViT's blocks)
    is row-parallel: this rank's input features (``local_in``: the caller
    passes just those), the f32 partial products summed over the model
    group, then the bias, one rounding (``_row_sum``)."""

    tp_aware = True

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        lecun_normal_(self.weight.data, cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype, gather: bool = True,
                local_in: bool = False) -> torch.Tensor:
        shard = shard_of(self)
        if shard is None:
            b = self.bias.to(dtype) if self.bias is not None else None
            return F.linear(x.to(dtype), self.weight.to(dtype), b)
        if shard.dim == 1:
            if not local_in:
                x = slice_in(x, shard, -1)
            # the dtype's products exactly, accumulated in f32
            y = F.linear(x.to(dtype).float(), self.weight.to(dtype).float())
            return _row_sum(y, self.bias, dtype, shard)
        b = slice_in(self.bias, shard, 0).to(dtype) if self.bias is not None else None
        y = F.linear(copy_in(x, shard).to(dtype), self.weight.to(dtype), b)
        return gather_out(y, shard) if gather else y


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
    eval takes neither.

    Under tensor parallelism a cut ``Conv_0.weight`` (its output channels)
    makes the block column-parallel: the conv computes this rank's
    channels, the BatchNorm normalises that slice (B3 on (N*H*W, C/P); its
    statistics reduced over the data group alone, since the model group's
    ranks hold other channels) and the ReLU runs on it, then the channels
    are joined. The opt-in routes are refused there."""

    tp_aware = True

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 act: bool = True, padding: int | None = None,
                 generator: torch.Generator | None = None, conv_bn_kernel: bool = False,
                 dw_kernel: bool = False, dilation: int = 1):
        super().__init__()
        pad = padding if padding is not None else dilation * (kernel // 2)
        self.Conv_0 = Conv(cin, features, kernel, stride, pad, generator=generator,
                           dilation=dilation)
        self.BatchNorm_0 = BatchNorm(features)
        self.act = act
        routable = (kernel == 3 and stride == 1 and dilation == 1 and padding is None
                    and cin % 128 == 0 and features % 128 == 0)
        self.conv_bn_kernel = conv_bn_kernel and routable and min(cin, features) >= 256
        self.dw_kernel = dw_kernel and routable

    def _takes_dw_route(self, x: torch.Tensor, dtype: torch.dtype) -> bool:
        b, h, w, cin = x.shape
        return self.dw_kernel and min(h, w) >= 6 and bool(pick_batch_block(
            b, h, w, cin, self.Conv_0.weight.shape[0], itemsize=dtype.itemsize))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        shard = shard_of(self.Conv_0)
        if shard is not None:
            if self.conv_bn_kernel or self.dw_kernel:
                raise NotImplementedError("ConvBNAct's conv_bn_kernel and dw_kernel routes take "
                                          "whole weights; tensor parallelism cuts this one")
            y = self.BatchNorm_0(self.Conv_0(x, dtype, gather=False), dtype, channels=shard)
            return gather_out(torch.relu(y) if self.act else y, shard)
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


# f32 elements a GroupNorm pass makes its temporaries for at once: its
# statistics are a sample's, so a large activation is taken a slice of the
# batch at a time (the DDPM's 128-channel 224^2 maps at b128 are 3.3 GB in
# f32 each, and a pass holds up to five such temporaries)
GN_CHUNK_ELEMENTS = 1 << 27


def _sample_slices(x: torch.Tensor) -> list[slice]:
    step = max(1, GN_CHUNK_ELEMENTS // max(1, x[0].numel()))
    return [slice(lo, lo + step) for lo in range(0, x.shape[0], step)]


class _GroupNorm(torch.autograd.Function):
    """flax ``nn.GroupNorm``'s function on NHWC with the analytic backward:
    f32 statistics over (H, W, the group's channels), the variance as
    E[x^2] - mean^2 clipped at 0 (flax's ``use_fast_variance``), one
    rounding of the result to the output dtype. The residuals are the input
    in its own dtype and per-(sample, group) f32 mean and rstd. Both passes
    take the batch ``GN_CHUNK_ELEMENTS`` f32 elements at a time (one slice
    for the most inputs: then it is one pass over the whole batch)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, out_dtype):
        c = x.shape[-1]
        g = scale.view(groups, c // groups)
        y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
        mus, rstds = [], []
        for sl in _sample_slices(x):
            xs = x[sl]
            xf = xs.float().reshape(xs.shape[0], -1, groups, c // groups)
            mu = xf.mean((1, 3), keepdim=True)
            var = (xf.square().mean((1, 3), keepdim=True) - mu.square()).clamp_min(0.0)
            rstd = torch.rsqrt(var + eps)
            y[sl] = ((xf - mu) * (rstd * g) + bias.view(groups, c // groups)).reshape(xs.shape)
            mus.append(mu)
            rstds.append(rstd)
        if len(mus) > 1:
            mus, rstds = [torch.cat(mus)], [torch.cat(rstds)]
        ctx.save_for_backward(x, mus[0], rstds[0], scale)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mu, rstd, scale = ctx.saved_tensors
        c, groups = x.shape[-1], ctx.groups
        g = scale.view(groups, c // groups)
        dx = torch.empty_like(x)
        dscale = torch.zeros(c, dtype=torch.float32, device=x.device)
        dbias = torch.zeros(c, dtype=torch.float32, device=x.device)
        for sl in _sample_slices(x):
            xs = x[sl]
            xhat = (xs.float().reshape(xs.shape[0], -1, groups, c // groups) - mu[sl]) * rstd[sl]
            dyf = dy[sl].float().reshape(xhat.shape)
            dscale += (dyf * xhat).sum((0, 1)).reshape(c)
            dbias += dyf.sum((0, 1)).reshape(c)
            dxhat = dyf * g
            m1 = dxhat.mean((1, 3), keepdim=True)
            m2 = (dxhat * xhat).mean((1, 3), keepdim=True)
            dx[sl] = (rstd[sl] * (dxhat - m1 - xhat * m2)).reshape(xs.shape)
        return dx, dscale, dbias, None, None, None


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon)`` on NHWC (``_GroupNorm``),
    its parameters ``scale`` (ones) and ``bias`` (zeros) f32, the output in
    the compute dtype. The ConvLSTM's gate norm (JAX ``models/convlstm.py:44``)."""

    def __init__(self, features: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        if num_groups <= 0 or features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {features} channels")
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _GroupNorm.apply(x, self.scale, self.bias, self.num_groups, self.eps, dtype)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pooling on NHWC with XLA's semantics: padding takes -inf."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC to ``size`` (JAX ``resize_nearest``,
    ``ops/nn.py:220``): integer upscale factors as a broadcast and a
    reshape; any other size with ``jax.image.resize(..., "nearest")``'s
    sampling, source index floor((i + 0.5) * in / out) computed in f32."""
    b, h, w, c = x.shape
    oh, ow = size
    if oh % h == 0 and ow % w == 0 and oh >= h and ow >= w:
        fy, fx = oh // h, ow // w
        return x[:, :, None, :, None, :].expand(b, h, fy, w, fx, c).reshape(b, oh, ow, c)

    def index(n_in: int, n_out: int) -> torch.Tensor:
        pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in) \
            / np.float32(n_out)
        return torch.from_numpy(np.floor(pos).astype(np.int64)).to(x.device)

    if oh != h:
        x = x.index_select(1, index(h, oh))
    if ow != w:
        x = x.index_select(2, index(w, ow))
    return x


def upsample2x(x: torch.Tensor, method: str = "nearest",
               align_corners: bool = False) -> torch.Tensor:
    """2x upsample of NHWC: nearest (broadcast + reshape, as the JAX package)
    or bilinear (``resize_bilinear``)."""
    h, w = x.shape[1:3]
    if method == "nearest":
        return resize_nearest(x, (2 * h, 2 * w))
    return resize_bilinear(x, (2 * h, 2 * w), align_corners=align_corners)


class TorchConvTranspose(nn.Module):
    """torch ``ConvTranspose2d`` geometry (kernel, stride, padding,
    output_padding) on NHWC: out = (in - 1) * stride - 2 * padding + kernel
    + output_padding, the JAX ``TorchConvTranspose`` (``ops/nn.py:562``).
    ``weight`` is (Cin, Cout, k, k), ``F.conv_transpose2d``'s layout and the
    flax (k, k, Cout, Cin) kernel transposed (3, 2, 0, 1), the bridge's one
    rule for 4-D kernels; the bias is added after, in the compute dtype.

    Under tensor parallelism JAX's rule cuts the kernel's last flax axis,
    which is Cin here (weight dim 0): the layer is row-parallel, each rank
    convolving its input channels and the f32 partial outputs summed over
    the model group, then the bias (``_row_sum``)."""

    tp_aware = True

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1, padding: int = 0,
                 output_padding: int = 0, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.weight = nn.Parameter(torch.empty(cin, features, kernel, kernel))
        # flax's variance_scaling(1/3, "fan_in", "uniform"), fan_in = k*k*Cin
        limit = math.sqrt(1.0 / (cin * kernel * kernel))
        nn.init.uniform_(self.weight.data, -limit, limit, generator=generator)
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        shard = shard_of(self)
        if shard is not None:
            # this rank's input channels; the dtype's products in f32 (_row_sum)
            x = slice_in(x, shard, -1).to(dtype).float()
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(dtype).float(),
                                   stride=self.stride, padding=self.padding,
                                   output_padding=self.output_padding)
            return _row_sum(y.permute(0, 2, 3, 1), self.bias, dtype, shard)
        y = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2), self.weight.to(dtype),
                               stride=self.stride, padding=self.padding,
                               output_padding=self.output_padding)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class ConvTranspose2x(nn.Module):
    """torch ``ConvTranspose2d(Cin, Cout, 2, stride=2)``, the exact 2x
    upsample of the JAX ``ConvTranspose2x`` (``ops/nn.py:501``), its one
    parameter module named ``up`` (``up.weight``, ``up.bias``). The JAX
    default computes it as a 1x1 conv to four phases and a depth-to-space;
    that is the same function (the k2/s2 windows do not overlap)."""

    def __init__(self, cin: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.up = TorchConvTranspose(cin, features, 2, stride=2, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.up(x, dtype)


def avg_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             padding: str | tuple = "VALID") -> torch.Tensor:
    """flax ``nn.avg_pool`` of NHWC (JAX ``avg_pool``, ``ops/nn.py:181``):
    ``padding`` "VALID", or ((top, bottom), (left, right)) of zeros, which
    count in the window's mean, as flax counts them."""
    y = x.permute(0, 3, 1, 2)
    if padding != "VALID":
        (top, bottom), (left, right) = padding
        y = F.pad(y, (left, right, top, bottom))
    return F.avg_pool2d(y, window, stride).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=64)
def _pool_matrix(in_dim: int, out_dim: int, device: torch.device) -> torch.Tensor:
    """(out_dim, in_dim) f32 averaging weights of torch ``AdaptiveAvgPool2d``:
    bin i averages rows [floor(i * in / out), ceil((i + 1) * in / out))."""
    m = np.zeros((out_dim, in_dim), np.float32)
    for i in range(out_dim):
        lo, hi = (i * in_dim) // out_dim, -(-((i + 1) * in_dim) // out_dim)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return torch.from_numpy(m).to(device)


def adaptive_avg_pool(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` of NHWC to ``size`` (JAX
    ``adaptive_avg_pool``, ``ops/nn.py:241``), any ratio (7 -> 2, 3, 6 have
    overlapping bins): two small averaging-matrix products in f32, cast
    back to x's dtype. Its backward is two products too, deterministic on
    the card, where ``F.adaptive_avg_pool2d``'s is not."""
    h, w = x.shape[1:3]
    oh, ow = size
    y = torch.einsum("oh,bhwc->bowc", _pool_matrix(h, oh, x.device), x.float())
    y = torch.einsum("pw,bowc->bopc", _pool_matrix(w, ow, x.device), y)
    return y.to(x.dtype).contiguous()


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W of NHWC, kept as (B, 1, 1, C)."""
    return x.mean(dim=(1, 2), keepdim=True)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """Max over H and W of NHWC, kept as (B, 1, 1, C)."""
    return x.amax(dim=(1, 2), keepdim=True)


class ChannelAttention(nn.Module):
    """Channel attention with average and max pooling branches through one
    shared bottleneck (JAX ``ChannelAttention``, ``ops/nn.py:605``):
    sigmoid(fc2(relu(fc1(avg))) + fc2(relu(fc1(max)))), ``fc1`` and ``fc2``
    1x1 convs without bias. Returns (B, 1, 1, C)."""

    def __init__(self, channels: int, ratio: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = Conv(channels, channels // ratio, 1, generator=generator)
        self.fc2 = Conv(channels // ratio, channels, 1, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        avg = self.fc2(torch.relu(self.fc1(global_avg_pool(x), dtype)), dtype)
        mx = self.fc2(torch.relu(self.fc1(global_max_pool(x), dtype)), dtype)
        return torch.sigmoid(avg + mx)


class _MaskedDrop(nn.Module):
    """A dropout whose keep-mask is drawn by :meth:`draw_mask` from
    ``generator`` (the step's; None: torch's default generator of the
    device); in training the kept values are scaled by 1 / (1 - rate).
    Inside a remat region the recompute applies the mask the first forward
    drew (``ops/remat.py``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def mask_shape(self, x: torch.Tensor) -> tuple[int, ...]:
        raise NotImplementedError

    def draw_mask(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """A bool keep-mask of ``mask_shape(x)``; under data parallelism drawn
        for the global batch and cut to this rank's rows
        (``parallel/mesh.draw_rows``)."""
        shape = self.mask_shape(x)
        u = draw_rows(lambda b: torch.rand((b, *shape[1:]), generator=generator,
                                           device=x.device), shape[0])
        return u < 1.0 - self.rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        region = active_region()
        if region is not None and region.replay:
            mask = region.replay_mask()
        else:
            mask = self.draw_mask(x, generator)
            if region is not None:
                region.record_mask(mask)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout2d(_MaskedDrop):
    """Channel dropout (torch ``Dropout2d``, the JAX ``Dropout2d`` of
    ``ops/nn.py:630``): in training, each (sample, channel) map of an NHWC
    tensor is kept with probability 1 - rate, a (B, 1, 1, C) mask."""

    def mask_shape(self, x):
        return (x.shape[0], 1, 1, x.shape[-1])


class DropPath(_MaskedDrop):
    """Stochastic depth (ChangeFormer's ``DropPath``, ``changeformer.py:38-48``):
    in training, each sample's residual branch is kept with probability
    1 - rate, a (B, 1, ..., 1) mask."""

    def mask_shape(self, x):
        return (x.shape[0],) + (1,) * (x.dim() - 1)


class PReLU(nn.Module):
    """torch ``nn.PReLU(num_parameters=C)``: a learned negative slope per
    channel, ``alpha`` (initialised 0.25; HFA-Net's ``PReLU``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


def replication_pad_to(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """torch ``ReplicationPad2d((0, dw, 0, dh))`` on NHWC: the last row and
    column repeated down and right up to (target_h, target_w). Written as a
    concatenation of expanded edge slices, whose backward is a sum with no
    scatter (``F.pad(mode="replicate")`` has no deterministic backward on
    the card)."""
    b, h, w, c = x.shape
    dh, dw = target_h - h, target_w - w
    if dh < 0 or dw < 0:
        raise ValueError(f"replication_pad_to: target {target_h}x{target_w} below {h}x{w}")
    if dw:
        x = torch.cat([x, x[:, :, w - 1:].expand(b, h, dw, c)], dim=2)
    if dh:
        x = torch.cat([x, x[:, h - 1:].expand(b, dh, target_w, c)], dim=1)
    return x


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_dim: int, out_dim: int, align_corners: bool,
                   device: torch.device, antialias: bool = False) -> torch.Tensor:
    """:func:`_interp_weights` as an f32 tensor on ``device``, made once per
    geometry: a host-to-device copy in every forward would wait on the
    card."""
    return torch.from_numpy(_interp_weights(in_dim, out_dim, align_corners, antialias)).to(
        device, torch.float32)


def _interp_weights(in_dim: int, out_dim: int, align_corners: bool,
                    antialias: bool = False) -> np.ndarray:
    """(out_dim, in_dim) linear-interpolation weights. align_corners=False
    is ``jax.image.resize``'s "linear": half-pixel centres, the triangle
    kernel's taps outside the input dropped and the rest renormalized (for
    upsampling the same as torch's ``align_corners=False``); a downsample
    needs ``antialias``, jax.image.resize's default, which widens the
    kernel by in / out. align_corners=True samples i * (in - 1) /
    (out - 1)."""
    m = np.zeros((out_dim, in_dim), np.float64)
    if align_corners:
        pos = (np.arange(out_dim) * (in_dim - 1) / (out_dim - 1) if out_dim > 1
               else np.zeros(1))
        lo = np.clip(np.floor(pos).astype(np.int64), 0, in_dim - 1)
        hi = np.clip(lo + 1, 0, in_dim - 1)
        frac = pos - lo
        for i in range(out_dim):
            m[i, lo[i]] += 1.0 - frac[i]
            m[i, hi[i]] += frac[i]
        return m
    scale = out_dim / in_dim
    if scale < 1.0 and not antialias:
        raise NotImplementedError("resize_bilinear downsamples only with antialiasing "
                                  "(jax.image.resize; resize_linear), which no model asks for")
    widen = max(1.0 / scale, 1.0)
    centres = (np.arange(out_dim) + 0.5) / scale - 0.5
    for i in range(out_dim):
        w = np.maximum(0.0, 1.0 - np.abs(np.arange(in_dim) - centres[i]) / widen)
        m[i] = w / w.sum()
    return m


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NHWC to ``size`` (JAX ``resize_bilinear``,
    ``ops/nn.py:193``), upsampling: two small interpolation-matrix products
    in f32, cast back to x's dtype (the JAX form of ``adaptive_avg_pool``).
    Its backward is two products too, deterministic on the card, where
    bilinear ``F.interpolate``'s backward is not."""
    return _resize(x, size, align_corners, antialias=False)


def resize_linear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (B, *size, C), "bilinear")`` of NHWC: as
    ``resize_bilinear`` upward, and antialiased downward (the kernel widened
    by in / out, jax.image.resize's default). The multi-scale loss resizes
    ChangeFormer's heads with it, as the JAX step does (``steps.py:207``)."""
    return _resize(x, size, False, antialias=True)


def _resize(x: torch.Tensor, size: tuple[int, int], align_corners: bool,
            antialias: bool) -> torch.Tensor:
    b, h, w, c = x.shape
    oh, ow = size
    my = _interp_matrix(h, oh, align_corners, x.device, antialias)
    mx = _interp_matrix(w, ow, align_corners, x.device, antialias)
    y = torch.einsum("oh,bhwc->bowc", my, x.float())
    y = torch.einsum("pw,bowc->bopc", mx, y)
    # einsum may return a permuted view; the NHWC layout is dense
    return y.to(x.dtype).contiguous()
