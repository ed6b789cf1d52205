"""3x3 convolution with its BatchNorm statistics in one pass, through the
hand-written kernel ``csrc/conv3x3.cu`` (B6).

Counterpart of ``kurosiwo_tpu/ops/pallas_conv_bn.py``: ``conv3x3_bn_stats``
replaces the Pallas ``conv3x3_bn_stats`` (optional relu(scale*x + bias)
prologue, 3x3 SAME stride-1 conv, (2, Cout) f32 [sum y, sum y^2] from the
f32 accumulator before y is rounded); ``conv3x3_bn`` is the custom VJP
``conv3x3_bn`` (``_cbn_fwd``/``_cbn_bwd``): training-mode BatchNorm on the
kernel's statistics, and a backward of the pair-sum kernel (B3) on the saved
pre-BN y, the BN dx algebra, then the library convolution's dx and dW in the
compute dtype (XLA's vjp in the JAX package), dW cast to the parameter's
dtype.

Layouts are the JAX package's: x (B, H, W, Cin) NHWC, w (3, 3, Cin, Cout)
HWIO. The wrapper takes the plain version for a CPU tensor; for a CUDA
tensor it launches the kernel that ``conv3x3_plan`` names for the call's
dtype and shape, or raises. ``conv3x3_bn_stats.launches`` counts kernel
wrapper calls, ``conv3x3_bn_stats.kernel_launches`` them by kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels
from .batchnorm import pair_sums


def taps(x: torch.Tensor):
    """The nine (dh, dw) shifts of a zero-padded NHWC tensor, as (tap,
    (B, H, W, C) view) pairs in HWIO tap order: the SAME conv's inputs."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    for dh in range(3):
        for dw in range(3):
            yield (dh, dw), xp[:, dh:dh + h, dw:dw + w, :]


def conv3x3_plain_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME stride-1 conv as the kernels compute it: the sum over the
    nine taps of (shifted x) @ w[tap], in f32 from the inputs' values;
    (B, H, W, Cout) f32."""
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    xf, wf = x.float(), w.float()
    y = torch.zeros((b * h * wd, cout), dtype=torch.float32, device=x.device)
    for (dh, dw), t in taps(xf):
        y += t.reshape(-1, cin) @ wf[dh, dw]
    return y.reshape(b, h, wd, cout)


def conv3x3_bn_stats_plain(x, w, scale=None, bias=None):
    """The TPU kernel's arithmetic in plain PyTorch: the prologue in f32,
    rounded to x's dtype (halo pixels stay 0: the padding comes after it),
    the conv in f32, statistics from the f32 result; returns (y in x's dtype,
    (2, Cout) f32)."""
    if scale is not None:
        x = torch.relu(x.float() * scale.float() + bias.float()).to(x.dtype)
    y = conv3x3_plain_f32(x, w)
    flat = y.reshape(-1, y.shape[-1])
    return y.to(x.dtype), torch.stack([flat.sum(0), (flat * flat).sum(0)])


def check_conv3x3(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    """Raise on shapes a 3x3 kernel does not take."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"{what} takes x (B, H, W, Cin) and w (3, 3, Cin, Cout), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"{what}: empty input")


def check_cuda(what: str, dtype: torch.dtype, device: torch.device,
               **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous ``dtype`` tensor (f32 or
    bf16) on the CUDA ``device``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes f32 or bf16, got {dtype}")
    for name, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, expected the CUDA device "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous tensors; {name} has strides "
                             f"{t.stride()}")


SMS = 132  # streaming multiprocessors of an H100 SXM
# the kernels of csrc/conv3x3.cu, by their Kernel number there
CONV3X3_KERNELS = {"simt": 0, "mma_sync": 1, "wgmma": 2}
# output pixels a block of each kernel owns (csrc/conv3x3.cu: tile_of)
PIXEL_TILE = {"simt": 64, "mma_sync": 128, "wgmma": 192}


class ConvPlan(NamedTuple):
    kernel: str   # a key of CONV3X3_KERNELS
    tiles: int    # pixel tiles of PIXEL_TILE[kernel]: B6's partials are (tiles, 2, Cout)


@functools.lru_cache(maxsize=None)
def conv3x3_plan(dtype: torch.dtype, m: int, cin: int, cout: int,
                 epilogue: str = "stats") -> ConvPlan:
    """The csrc/conv3x3.cu kernel of one B6 call over m = B*H*W output
    pixels; ``epilogue`` is "stats" or "prologue" (with its relu(scale*x +
    bias) prologue). f32 takes the CUDA-core kernel; bf16 without the
    prologue at Cin % 64 == 0 and Cout % 128 == 0 (every routed call) the
    wgmma kernel; the rest of bf16 the mma.sync kernel. The kernel refuses a
    call it does not take (the wrapper raises). B8 has its own plan
    (conv_fused.conv3x3_fused_plan)."""
    if epilogue not in ("stats", "prologue"):
        raise ValueError(f"conv3x3_plan: unknown epilogue {epilogue!r}")
    if dtype == torch.float32:
        kernel = "simt"
    elif epilogue == "stats" and cin % 64 == 0 and cout % 128 == 0:
        kernel = "wgmma"
    else:
        kernel = "mma_sync"
    return ConvPlan(kernel, -(-m // PIXEL_TILE[kernel]))


def check_aligned(what: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the wgmma
    kernels copy 16 bytes at a time)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs 16-byte aligned tensors; {name} is not")


def lib():
    """``csrc/conv3x3.cu`` (B6, and B8 off the slab kernel), its argument
    types set once."""
    lib = kernels.library("conv3x3")
    if lib.ks_conv3x3_bn_stats.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ks_conv3x3_bn_stats.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, i, i, i, p]
        lib.ks_conv3x3_bn_stats.restype = i
        lib.ks_conv3x3_bias_act.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, i, p]
        lib.ks_conv3x3_bias_act.restype = i
    return lib


def conv3x3_bn_stats(x, w, scale=None, bias=None):
    """(y, stats): y (B, H, W, Cout) in x's dtype, the 3x3 SAME conv of
    x (after relu(scale*x + bias) when ``scale`` is given) with w (3, 3,
    Cin, Cout) of x's dtype; stats (2, Cout) f32 [sum y, sum y^2] over
    (B, H, W). One call is two launches (the conv with per-tile partials,
    then their fixed-order sum)."""
    check_conv3x3(x, w, "conv3x3_bn_stats")
    if (scale is None) != (bias is None):
        raise ValueError("conv3x3_bn_stats: give both prologue scale and bias, or neither")
    if x.device.type == "cpu":
        return conv3x3_bn_stats_plain(x, w, scale, bias)
    b, h, wd, cin = x.shape
    plan = conv3x3_plan(x.dtype, b * h * wd, cin, w.shape[-1],
                        "stats" if scale is None else "prologue")
    return launch_bn_stats(plan, x, w, scale, bias)


def launch_bn_stats(plan: ConvPlan, x, w, scale=None, bias=None):
    """``conv3x3_bn_stats`` on the card through ``plan``'s kernel; raises
    when that kernel does not take the call (csrc/conv3x3.cu refuses it
    before any launch)."""
    check_cuda("conv3x3_bn_stats", x.dtype, x.device, x=x, w=w)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    if plan.kernel == "wgmma":
        check_aligned("conv3x3_bn_stats", x=x, w=w)
    if scale is not None:
        if scale.shape != (cin,) or bias.shape != (cin,):
            raise ValueError(f"conv3x3_bn_stats: prologue scale and bias must be ({cin},)")
        check_cuda("conv3x3_bn_stats prologue", torch.float32, x.device, scale=scale, bias=bias)
    k = lib()
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    partials = torch.empty((plan.tiles, 2, cout), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    err = k.ks_conv3x3_bn_stats(
        x.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), partials.data_ptr(),
        stats.data_ptr(), b * h * wd, h, wd, cin, cout, int(x.dtype == torch.bfloat16),
        CONV3X3_KERNELS[plan.kernel], kernels.stream_ptr(x))
    kernels.check(k, err, f"conv3x3_bn_stats {plan.kernel} launch")
    conv3x3_bn_stats.launches += 1
    conv3x3_bn_stats.kernel_launches[plan.kernel] += 1
    return y, stats


conv3x3_bn_stats.launches = 0
conv3x3_bn_stats.kernel_launches = dict.fromkeys(CONV3X3_KERNELS, 0)


def conv_backward(x, w, dy, needs_x: bool, needs_w: bool):
    """dx (B, H, W, Cin) and dW (3, 3, Cin, Cout) of the SAME 3x3 conv of x
    with w for the output cotangent dy, by the library convolution's
    backward in the inputs' dtype (XLA's vjp in the JAX package): one call
    to the op autograd runs for ``F.conv2d``, on the channels-last views, so
    it keeps their layout; None where not needed."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None, [1, 1],
        [1, 1], [1, 1], False, [0, 0], 1, [needs_x, needs_w, False])
    return (dx.permute(0, 2, 3, 1) if needs_x else None,
            dw.permute(2, 3, 1, 0) if needs_w else None)


class _ConvBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, bias, eps):
        dt = x.dtype
        # the kernel's (9*Cin, Cout) rows in x's dtype, cast and laid out in one pass
        wk = torch.empty(w.shape, dtype=dt, device=w.device).copy_(w)
        y, st = conv3x3_bn_stats(x, wk)
        n = y.numel() // y.shape[-1]
        mean = st[0] / n
        var = st[1] / n - mean * mean
        inv = torch.rsqrt(var + eps)
        out = y * (inv * scale).to(dt) + (bias - mean * inv * scale).to(dt)
        ctx.save_for_backward(x, wk, y, mean, inv, scale)
        ctx.w_dtype = w.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, wk, y, mean, inv, scale = ctx.saved_tensors
        n = y.numel() // y.shape[-1]
        # the kernel and the elementwise pass take dense channels-last
        s = pair_sums(dout.contiguous(), y)
        dbeta = s[0]
        dgamma = inv * (s[1] - mean * s[0])
        dt = y.dtype
        a_f = scale * inv
        b_f = -a_f * inv * dgamma / n
        c_f = -a_f * (dbeta / n) - b_f * mean
        dy = dout * a_f.to(dt) + y * b_f.to(dt) + c_f.to(dt)
        dx, dw = conv_backward(x, wk, dy, ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return dx, None if dw is None else dw.to(ctx.w_dtype), dgamma, dbeta, None


def conv3x3_bn(x, w, scale, bias, eps: float = 1e-5):
    """3x3 SAME stride-1 conv (w cast to x's dtype) -> training-mode
    BatchNorm on statistics from the same kernel pass; returns (out in x's
    dtype, f32 batch mean, f32 biased variance)."""
    return _ConvBN.apply(x, w, scale, bias, eps)
