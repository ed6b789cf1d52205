"""Weight gradient of a 3x3 convolution through the hand-written kernel
``csrc/conv_dw.cu`` (B7).

Counterpart of ``kurosiwo_tpu/ops/pallas_dw.py``: ``conv3x3_dw`` replaces the
Pallas ``conv3x3_dw`` ((3, 3, Cin, Cout) f32 = sum over B*H*W of
x[p + tap]^T dy[p]); ``conv3x3_pdw`` is the custom VJP ``conv3x3_pdw``: its
forward and dx stay the library convolution (XLA's in the JAX package) and
only dW is the kernel, cast to the weight's dtype (``pallas_dw.py:167``: the
route passes the compute-dtype weight, so a bf16 step rounds dW to bf16
before the f32 parameter sees it). ``pick_batch_block`` is the JAX package's
VMEM-fit model, kept only as the routing gate of ``ConvBNAct`` (a 0 sends a
layer down the default branch, as ``ops/nn.py:466-470`` does); the CUDA
kernel tiles on its own.

Layouts: x (B, H, W, Cin), dy (B, H, W, Cout), w (3, 3, Cin, Cout). The
wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel that ``conv3x3_dw_plan`` names for the call's dtype and
shape, or raises. ``conv3x3_dw.launches`` counts kernel wrapper calls,
``conv3x3_dw.kernel_launches`` them by kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels
from .conv_bn import SMS, check_aligned, check_cuda, conv_backward, taps


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pick_batch_block(b: int, h: int, w: int, cin: int, cout: int,
                     itemsize: int = 2, budget: int = 15 * 2 ** 20) -> int:
    """Largest batch block whose TPU kernel fits 15 MiB of scoped VMEM
    (3*(x+dy tiles) + the f32 accumulator), 0 when none does; a copy of
    ``pallas_dw.pick_batch_block``."""
    wp = _round_up(w + 2, 8)
    acc = 9 * cin * cout * 4
    for bb in (16, 8, 4, 2, 1):
        if b % bb:
            continue
        tiles = bb * (h + 4) * wp * (cin + cout) * itemsize
        if 3 * tiles + acc <= budget:
            return bb
    return 0


def conv3x3_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain PyTorch: for each tap, (shifted
    x)^T @ dy in f32 from the inputs' values; (3, 3, Cin, Cout) f32."""
    cin, cout = x.shape[-1], dy.shape[-1]
    dyf = dy.float().reshape(-1, cout)
    out = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    for (dh, dw), t in taps(x.float()):
        out[dh, dw] = t.reshape(-1, cin).t() @ dyf
    return out


# the kernels of csrc/conv_dw.cu, by their Kernel number there
DW_KERNELS = {"simt": 0, "wgmma": 1}


class DwPlan(NamedTuple):
    kernel: str   # a key of DW_KERNELS: "wgmma" (bf16) or "simt" (f32)
    step: int     # pixels a K chunk takes
    splits: int   # K slices: the partials are (splits, 9, Cin, Cout) f32
    slice: int    # pixels a block sums: a multiple of step, splits * slice >= B*H*W
    tiles: int    # blocks of one slice (the grid is splits x tiles)


def _simt_splits(p: int, tiles: int) -> int:
    # about two blocks on each SM, at least 4 chunks of 16 pixels a slice
    return max(1, min(-(-2 * SMS // tiles), -(-p // 64)))


def _wgmma_splits(p: int, tiles: int, cin: int, cout: int) -> int:
    # One block per SM (a 160 KB ring): the fewest chunk steps on the
    # busiest SM, the waves of blocks times the chunks of a slice, plus the
    # partials each split adds (9 Cin Cout f32 written and read) at 2 MB of
    # device memory traffic per chunk step (a 128 x 128 x 64 chunk takes
    # about 0.63 us on an H100, and 3.35 TB/s moves 2.1 MB in that time);
    # at least 4 chunks a slice, so the ring fills.
    def cost(s: int) -> float:
        chunks = -(-p // (64 * s))
        return -(-tiles * s // SMS) * chunks + s * 9 * cin * cout * 8 / 2e6
    return min(range(1, max(1, p // 256) + 1), key=cost)


@functools.lru_cache(maxsize=None)
def conv3x3_dw_plan(dtype: torch.dtype, p: int, cin: int, cout: int) -> DwPlan:
    """The csrc/conv_dw.cu kernel and its K split for p = B*H*W pixels:
    bf16 takes the wgmma kernel (one tap's 128 x 128 Cin x Cout a block,
    64-pixel chunks), f32 the CUDA-core kernel (64 x 64, 16). Cached: a
    train step asks for the same few shapes every step."""
    tile, kernel, step = (128, "wgmma", 64) if dtype == torch.bfloat16 else (64, "simt", 16)
    tiles = 9 * -(-cin // tile) * -(-cout // tile)
    splits = (_wgmma_splits(p, tiles, cin, cout) if kernel == "wgmma"
              else _simt_splits(p, tiles))
    slice_ = -(-p // splits)
    return DwPlan(kernel, step, splits, -(-slice_ // step) * step, tiles)


def _lib():
    lib = kernels.library("conv_dw")
    if lib.ks_conv3x3_dw.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ks_conv3x3_dw.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, i, ll, p]
        lib.ks_conv3x3_dw.restype = i
    return lib


def conv3x3_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) f32 weight gradient of the 3x3 SAME stride-1 conv
    whose input is x (B, H, W, Cin) and whose output cotangent is dy (B, H,
    W, Cout). One call is two launches (per-slice partials of K = B*H*W,
    then their fixed-order sum)."""
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"conv3x3_dw takes x (B, H, W, Cin) and dy (B, H, W, Cout), got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    if x.numel() == 0 or dy.numel() == 0:
        raise ValueError("conv3x3_dw: empty input")
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, dy)
    b, h, w, cin = x.shape
    return launch_dw(conv3x3_dw_plan(x.dtype, b * h * w, cin, dy.shape[-1]), x, dy)


def launch_dw(plan: DwPlan, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``conv3x3_dw`` on the card through ``plan``; raises when its kernel
    or split does not take the call (csrc/conv_dw.cu refuses it before any
    launch)."""
    check_cuda("conv3x3_dw", x.dtype, x.device, x=x, dy=dy)
    b, h, w, cin = x.shape
    cout = dy.shape[-1]
    if cin % 8 or cout % 8:
        raise ValueError(f"conv3x3_dw kernel needs Cin and Cout multiples of 8, got {cin}, {cout}")
    p = b * h * w
    if plan.kernel == "wgmma":
        check_aligned("conv3x3_dw", x=x, dy=dy)
    k = _lib()
    partials = torch.empty((plan.splits, 9, cin, cout), dtype=torch.float32, device=x.device)
    out = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    err = k.ks_conv3x3_dw(x.data_ptr(), dy.data_ptr(), partials.data_ptr(), out.data_ptr(),
                          p, h, w, cin, cout, int(x.dtype == torch.bfloat16),
                          DW_KERNELS[plan.kernel], plan.splits, plan.slice, kernels.stream_ptr(x))
    kernels.check(k, err, f"conv3x3_dw {plan.kernel} launch")
    conv3x3_dw.launches += 1
    conv3x3_dw.kernel_launches[plan.kernel] += 1
    return out


conv3x3_dw.launches = 0
conv3x3_dw.kernel_launches = dict.fromkeys(DW_KERNELS, 0)


def conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The library 3x3 SAME stride-1 conv of x (B, H, W, Cin) with w (3, 3,
    Cin, Cout), on the channels-last NCHW view."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


class _ConvPDW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv_same(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = conv_backward(x, w, dy, True, False)[0] if ctx.needs_input_grad[0] else None
        dw = conv3x3_dw(x, dy.contiguous()).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def conv3x3_pdw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME stride-1 conv of x with w (3, 3, Cin, Cout), both in the
    compute dtype, whose weight gradient is the B7 kernel."""
    return _ConvPDW.apply(x, w)
