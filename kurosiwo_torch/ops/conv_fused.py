"""Forward 3x3 convolution with a bias (+ ReLU) epilogue for small channel
counts (B8), through hand-written kernels: in bf16 the slab kernel of
``csrc/conv_fused.cu`` (halo slabs by TMA, resident weights, wgmma, TMA
stores), else the second epilogue of B6's implicit GEMM in
``csrc/conv3x3.cu`` (``tc_conv3x3`` on mma.sync, ``simt_conv3x3`` in f32).

Counterpart of ``kurosiwo_tpu/ops/pallas_conv.py::conv3x3_fused``
(``_conv_kernel``): y = [relu](conv3x3_SAME(x, w) + b) in x's dtype, the
bias added in f32. Like the TPU kernel it is wired into no model: no path of
the port launches it; ``chip_smoke.py`` holds it against its plain version
at the UNet's 224^2 x 16 and 112^2 x 32 decoder shapes.

Layouts: x (B, H, W, Cin), w (3, 3, Cin, Cout), b (Cout,). The wrapper takes
the plain version for a CPU tensor; for a CUDA tensor it launches the kernel
that ``conv3x3_fused_plan`` names for the call's dtype, shape and alignment,
or raises. ``conv3x3_fused.launches`` counts kernel wrapper calls,
``conv3x3_fused.kernel_launches`` them by kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import kernels
from .conv_bn import (CONV3X3_KERNELS, PIXEL_TILE, SMS, check_conv3x3, check_cuda,
                      conv3x3_plain_f32)
from .conv_bn import lib as conv3x3_lib

SMEM_LIMIT = 232448   # dynamic shared memory one block may take on an H100 (227 KB)
SLABS = 2             # the slab kernel's halo slabs in flight (csrc/conv_fused.cu: kSlabs)
BAND_ROWS = (8, 6, 4, 2)  # the slab kernel's band heights R, the first that fits taken


class FusedPlan(NamedTuple):
    kernel: str     # "slab" (csrc/conv_fused.cu), "mma_sync" or "simt" (csrc/conv3x3.cu)
    rows: int       # slab: output rows R of a band (one work item); else 0
    smem: int       # slab: dynamic shared bytes of a block; else 0
    grid: int       # slab: resident blocks walking the B ceil(H / R) bands; else pixel tiles


def _round_1k(v: int) -> int:
    return -(-v // 1024) * 1024


def slab_smem(w: int, cin: int, cout: int, rows: int) -> int:
    """csrc/conv_fused.cu's Layout: SLABS (R + 2) x (W + 2) x Cin halo slabs,
    two half-band (R / 2) x W x Cout output tiles (each 1 KB aligned), the
    weights as ceil(9 Cin / 64) K-major tiles of Cout rows x 128 bytes, 8
    mbarriers and 1 KB of alignment slack."""
    return (SLABS * _round_1k((rows + 2) * (w + 2) * cin * 2)
            + 2 * _round_1k(rows // 2 * w * cout * 2)
            + -(-9 * cin // 64) * cout * 128 + 8 * 8 + 1024)


def slab_takes(h: int, w: int, cin: int, cout: int, rows: int) -> bool:
    """Whether the slab kernel takes a bf16 call with bands of ``rows``:
    Cin and Cout multiples of 16 up to 64 (the weights stay resident, an
    accumulator is one wgmma of N = Cout), a halo box W + 2 <= 256 pixels
    wide and R + 2 <= 256 rows high (TMA's box limit), R even (two half-band
    stores) and the layout within one block's shared memory."""
    return (cin % 16 == 0 and 16 <= cin <= 64 and cout % 16 == 0 and 16 <= cout <= 64
            and h >= 1 and 1 <= w and w + 2 <= 256 and rows >= 2 and rows % 2 == 0
            and rows + 2 <= 256 and slab_smem(w, cin, cout, rows) <= SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def conv3x3_fused_plan(dtype: torch.dtype, b: int, h: int, w: int, cin: int, cout: int,
                       aligned: bool, sms: int = SMS) -> FusedPlan:
    """The kernel of one call on (B, H, W, Cin) -> Cout. bf16 takes the slab
    kernel where ``slab_takes`` with some R of ``BAND_ROWS`` (the first that
    fits, at most H rounded up to even) and x is 16-byte aligned
    (``aligned``; TMA reads from a 16-byte boundary; y is new); its grid is
    one block on each of ``sms`` SMs, at most one a band. One block is all
    an SM holds, by the kernel's registers (17 warps of 70-95 registers at
    Cout 16 and 32, 9 of 100-138 at 48 and 64): its occupancy is one block
    at every Cout and Cin (the card tests hold the grid to it). Other bf16
    calls take the mma.sync kernel, f32 the CUDA-core kernel. The kernel
    refuses a call it does not take (the wrapper raises)."""
    if dtype == torch.float32:
        return FusedPlan("simt", 0, 0, -(-b * h * w // PIXEL_TILE["simt"]))
    if dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_fused_plan: no kernel takes {dtype}")
    top = h + h % 2
    for rows in BAND_ROWS:
        if rows <= max(top, 2) and aligned and slab_takes(h, w, cin, cout, rows):
            return FusedPlan("slab", rows, slab_smem(w, cin, cout, rows),
                             min(b * -(-h // rows), sms))
    return FusedPlan("mma_sync", 0, 0, -(-b * h * w // PIXEL_TILE["mma_sync"]))


def _lib():
    lib = kernels.library("conv_fused")
    if lib.ks_conv3x3_slab.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ks_conv3x3_slab.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.ks_conv3x3_slab.restype = i
        lib.ks_conv3x3_slab_smem.argtypes = [i, i, i, i]
        lib.ks_conv3x3_slab_smem.restype = ctypes.c_longlong
        lib.ks_conv3x3_slab_blocks_per_sm.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.ks_conv3x3_slab_blocks_per_sm.restype = i
    return lib


def conv3x3_fused_plain(x, w, b, relu: bool = True):
    """The TPU kernel's arithmetic: the conv in f32, plus the f32 bias,
    [ReLU], rounded to x's dtype."""
    y = conv3x3_plain_f32(x, w) + b.float()
    return (torch.relu(y) if relu else y).to(x.dtype)


def _check_shapes(x, w, b) -> None:
    check_conv3x3(x, w, "conv3x3_fused")
    if b.shape != (w.shape[-1],):
        raise ValueError(f"conv3x3_fused: bias must be ({w.shape[-1]},), got {tuple(b.shape)}")


def conv3x3_fused(x, w, b, relu: bool = True):
    """[relu](conv3x3 SAME stride 1 (x, w) + b), (B, H, W, Cout) in x's
    dtype; any Cin and Cout."""
    _check_shapes(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, w, b, relu)
    bsz, h, wd, cin = x.shape
    plan = conv3x3_fused_plan(x.dtype, bsz, h, wd, cin, w.shape[-1], x.data_ptr() % 16 == 0,
                              sm_count(x.device.index))
    return launch_fused(plan, x, w, b, relu)


def launch_fused(plan: FusedPlan, x, w, b, relu: bool = True):
    """``conv3x3_fused`` on the card through ``plan``'s kernel; raises when
    that kernel does not take the call (the C entry points refuse it before
    any launch)."""
    _check_shapes(x, w, b)
    check_cuda("conv3x3_fused", x.dtype, x.device, x=x, w=w)
    bias = b.float().contiguous()
    check_cuda("conv3x3_fused", torch.float32, x.device, b=bias)
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    stream = kernels.stream_ptr(x)
    if plan.kernel == "slab":
        k = _lib()
        err = k.ks_conv3x3_slab(x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(), bsz, h,
                                wd, cin, cout, int(relu), plan.rows, plan.grid, stream)
    else:
        k = conv3x3_lib()
        err = k.ks_conv3x3_bias_act(x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
                                    bsz * h * wd, h, wd, cin, cout, int(relu),
                                    int(x.dtype == torch.bfloat16), CONV3X3_KERNELS[plan.kernel],
                                    stream)
    kernels.check(k, err, f"conv3x3_fused {plan.kernel} launch")
    conv3x3_fused.launches += 1
    conv3x3_fused.kernel_launches[plan.kernel] += 1
    return y


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """Streaming multiprocessors of card ``device``: the slab plan's grid."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def slab_smem_of_kernel(w: int, cin: int, cout: int, rows: int) -> int:
    """The slab kernel's own count of its shared bytes (0: does not fit),
    for the card tests to hold ``slab_smem`` against."""
    return _lib().ks_conv3x3_slab_smem(w, cin, cout, rows)


def slab_blocks_per_sm(w: int, cin: int, cout: int, rows: int) -> int:
    """Blocks of the slab kernel one SM of the current card holds at once
    at this layout (its occupancy), for the card tests to hold the plan's
    grid against."""
    lib, n = _lib(), ctypes.c_int(0)
    kernels.check(lib, lib.ks_conv3x3_slab_blocks_per_sm(w, cin, cout, rows, ctypes.byref(n)),
                  "conv3x3_fused slab occupancy")
    return n.value


conv3x3_fused.launches = 0
conv3x3_fused.kernel_launches = {"slab": 0, "mma_sync": 0, "simt": 0}
