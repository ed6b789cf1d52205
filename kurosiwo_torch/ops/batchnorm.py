"""BatchNorm whose statistics and gradient reductions run through the
hand-written pair-sum kernel (``csrc/pair_sums.cu``).

Counterpart of ``kurosiwo_tpu/ops/pallas_bn.py``: ``pair_sums`` replaces the
Pallas ``_pair_kernel``; ``bn_train_apply`` is the custom-vjp BN whose forward
takes (sum x, sum x*x) and whose backward takes (sum dy, sum dy*x) from that
kernel; ``BatchNorm`` follows flax, not ``torch.nn.BatchNorm2d``: momentum
0.9 on the running statistics (torch's 0.1), BIASED running variance
E[x^2] - mean^2, eps 1e-5, and the flax eval formula.

Tensors are channels-last: (..., C) with C the last, contiguous axis.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import kernels

_TILE = 128  # columns a kernel block covers; also the width of the narrow-C fold
_TARGET_BLOCKS = 132 * 8  # 8 blocks of 256 threads on each of the H100's 132 SMs


def pair_sums_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (2, C) f32 = (sum(a), sum(a*b)) over all but
    the last axis."""
    c = a.shape[-1]
    af = a.reshape(-1, c).float()
    bf = b.reshape(-1, c).float()
    return torch.stack([af.sum(0), (af * bf).sum(0)])


def launch_geometry(numel: int, c: int) -> tuple[int, int, int, int]:
    """(rows, width, blocks, rows per block) of the kernel's view of a
    (numel/C, C) tensor: the JAX fold (numel/128, 128) when C divides 128
    and 128 divides numel, else (numel/C, C) in 128-column tiles."""
    if _TILE % c == 0 and numel % _TILE == 0:
        rows, width = numel // _TILE, _TILE  # column l holds channel l % C
    else:
        rows, width = numel // c, c
    tiles = -(-width // _TILE)
    nblk = max(1, min(_TARGET_BLOCKS // tiles, -(-rows // 8)))
    rows_per_block = -(-rows // nblk)
    return rows, width, -(-rows // rows_per_block), rows_per_block


def _pair_sums_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"pair_sums kernel takes two f32 or two bf16 tensors, got {a.dtype}, {b.dtype}")
    if a.shape != b.shape or b.device != a.device:
        raise ValueError(f"pair_sums: shapes/devices differ: {a.shape} {a.device}, {b.shape} {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("pair_sums kernel needs contiguous channels-last (..., C) tensors")
    c = a.shape[-1]
    if a.numel() == 0:
        raise ValueError("pair_sums: empty input")
    rows, width, nblk, rows_per_block = launch_geometry(a.numel(), c)
    partials = torch.empty((nblk, 2, width), dtype=torch.float32, device=a.device)
    out = torch.empty((2, c), dtype=torch.float32, device=a.device)
    lib = _lib()
    err = lib.ks_pair_sums(
        a.data_ptr(), b.data_ptr(), partials.data_ptr(), out.data_ptr(),
        rows, width, c, nblk, rows_per_block, int(a.dtype == torch.bfloat16),
        kernels.stream_ptr(a),
    )
    kernels.check(lib, err, "pair_sums launch")
    pair_sums.launches += 1
    return out


def _lib():
    import ctypes

    lib = kernels.library("pair_sums")
    if lib.ks_pair_sums.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ks_pair_sums.argtypes = [p, p, p, p, ll, i, i, i, ll, i, p]
        lib.ks_pair_sums.restype = i
    return lib


def pair_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-channel (sum(a), sum(a*b)) in f32 over all leading axes, as a
    (2, C) tensor. A CUDA tensor goes through the kernel (one launch for the
    block partials, one for their fixed-order sum; ``pair_sums.launches``
    counts the pair), a CPU tensor through :func:`pair_sums_plain`."""
    if a.device.type == "cpu":
        return pair_sums_plain(a, b)
    return _pair_sums_cuda(a, b)


pair_sums.launches = 0


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        c = x.shape[-1]
        n = x.numel() // c
        s = pair_sums(x, x)
        mean = s[0] / n
        var = s[1] / n - mean * mean
        inv = torch.rsqrt(var + eps)
        # elementwise pass in x.dtype (flax semantics): per-channel factors
        # are folded in f32 and cast once; the big tensor never upcasts
        dt = x.dtype
        y = x * (inv * scale).to(dt) + (bias - mean * inv * scale).to(dt)
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, scale = ctx.saved_tensors
        c = x.shape[-1]
        n = x.numel() // c
        # autograd may hand a strided gradient (e.g. a slice of a concat's
        # gradient); the kernel and the elementwise pass take dense
        # channels-last, so the gradient is made dense here (no copy when
        # it already is)
        dy = dy.contiguous()
        s = pair_sums(dy, x)
        sum_dy, sum_dyx = s[0], s[1]
        dbeta = sum_dy
        dgamma = inv * (sum_dyx - mean * sum_dy)
        # dx = (scale*inv) * (dy - (dbeta + xhat*dgamma)/n), regrouped as
        # A*dy + B*x + C with f32 per-channel factors cast once
        dt = x.dtype
        a_f = scale * inv
        b_f = -a_f * inv * dgamma / n
        c_f = -a_f * (dbeta / n) - b_f * mean
        dx = dy * a_f.to(dt) + x * b_f.to(dt) + c_f.to(dt)
        return dx, dgamma, dbeta, None


def bn_train_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """Training-mode batch norm over all but the last axis: (y, mean, var),
    y in x.dtype, f32 batch mean and biased variance."""
    return _BNTrain.apply(x, scale, bias, eps)


class BatchNorm(nn.Module):
    """flax-semantics BatchNorm over the last axis of a channels-last tensor.

    Parameters ``scale`` and ``bias`` and buffers ``mean`` and ``var`` carry
    the flax variable names, so a flax ``BatchNorm_N`` subtree maps onto it
    by name (``kurosiwo_torch/convert.py``)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        out_dtype = dtype or x.dtype
        if not self.training:
            inv = torch.rsqrt(self.var + self.eps)
            y = (x.float() - self.mean) * (inv * self.scale) + self.bias
            return y.to(out_dtype)
        y, mean, var = bn_train_apply(x.to(out_dtype), self.scale, self.bias, self.eps)
        self.update_running(mean, var)
        return y

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold a batch's f32 mean and biased variance into the running
        statistics with flax's momentum."""
        m = self.momentum
        self.mean.copy_(m * self.mean + (1.0 - m) * mean)
        self.var.copy_(m * self.var + (1.0 - m) * var)
