"""Non-causal flash attention on (B, H, N, D) tensors, forward and backward,
through the hand-written kernels of ``csrc/flash_attention.cu`` (B5).

Counterpart of the flash part of ``kurosiwo_tpu/ops/pallas_attention.py``:
``flash_attention_fwd`` replaces ``_flash_fwd`` and its ``_fwd_kernel``,
``flash_attention_dq`` the ``_dq_kernel`` and ``flash_attention_dkv`` the
``_dkv_kernel`` of ``flash_bwd``. ``flash_attention_bwd`` is ``flash_bwd``
itself: it takes the caller's lse and delta, so a ring pass (ROADMAP A12) can
hand it global statistics with each rotating k/v block. ``FlashAttention`` is
the custom VJP (residuals q, k, v, out, lse, as ``_flash_vjp_fwd``), with
delta = sum_d(do * out) computed in plain PyTorch between the two calls, as
``_flash_vjp_bwd`` computes it.

Layout: q (B, H, Nq, D), k and v (B, H, Nk, D), each with unit stride in D
and any batch, head and row strides, so the column-thirds of a packed qkv
projection go in as views with no copy. On the card, out and the gradients
are (B, H, N, D) views of (B, N, H, D) memory: ``attention_packed`` merges
them back to (B, N, H*D) with no copy. lse is (B, H, Nq) f32.

Numerics: the TPU kernel keeps the scores, p and ds in f32 through every
product, and so do the plain versions here (B4's plain versions round p to
v's dtype instead). The f32 kernel does the same; the bf16 kernels round p
and ds to bf16 as tensor-core operands, their one deviation.

A wrapper takes the plain version for a CPU tensor (any D); for a CUDA
tensor it launches the kernel that ``flash_plan`` names for the call's dtype
and shape (f32 or bf16, D in {32, 64, 128}) or raises: bf16 at D 64 and 128
runs the Hopper kernels (wgmma fed by TMA), bf16 at D 32 the mma.sync ones,
f32 the CUDA-core ones. ``.launches`` counts kernel launches of each
wrapper, ``.kernel_launches`` them by kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import kernels

HEAD_DIMS = (32, 64, 128)
# the kernels of csrc/flash_attention.cu, by their Kernel number there
FLASH_KERNELS = {"simt": 0, "mma_sync": 1, "wgmma": 2}
SMEM_LIMIT = 232448  # dynamic shared memory one block may take on an H100 (227 KB)


class FlashPlan(NamedTuple):
    kernel: str     # a key of FLASH_KERNELS
    q_tile: int     # query rows of a forward or dq block: grid (ceil(Nq / q_tile), B*H)
    k_tile: int     # key rows of a dk/dv block: grid (ceil(Nk / k_tile), B*H)
    fwd_smem: int   # dynamic shared memory of a block, bytes
    dq_smem: int
    dkv_smem: int


def _simt_smem(d: int) -> tuple[int, int, int]:
    tile, score = 4 * 64 * (d + 1), 4 * 64 * 65
    return 3 * tile + score, 4 * tile + score + 2 * 64 * 4, 4 * tile + 2 * score + 2 * 64 * 4


def _mma_sync_smem(d: int) -> tuple[int, int, int]:
    tile = 2 * 64 * (d + 8)
    return 5 * tile, 6 * tile + 2 * 64 * 4, 6 * tile + 4 * 64 * 4


def _wgmma_smem(d: int) -> tuple[int, int, int]:
    """csrc/flash_attention.cu's FwdLayout, DqLayout, DkvLayout: B128 tiles
    of 2 d bytes a row, mbarriers of 8 bytes, 1 KB of alignment slack."""
    own, fwd_kv, tile, stages = 128 * d * 2, 128 * d * 2, 64 * d * 2, 4
    fwd = own + 2 * 2 * fwd_kv + 8 * (1 + 4 * 2) + 1024
    dq = 2 * own + stages * 2 * tile + 8 * (1 + 2 * stages) + 1024
    dkv = 2 * own + stages * (2 * tile + 2 * 64 * 4) + 8 * (1 + 2 * stages) + 1024
    return fwd, dq, dkv


@functools.lru_cache(maxsize=None)
def flash_plan(dtype: torch.dtype, d: int, nq: int, nk: int) -> FlashPlan:
    """The csrc/flash_attention.cu kernels of one call: f32 the CUDA-core
    kernels, bf16 at D 64 and 128 the Hopper kernels (wgmma fed by TMA,
    128-row blocks of 384 threads, one an SM), bf16 at D 32 the mma.sync
    kernels (64-row blocks). nq and nk size the grids the plan's tiles
    give. The kernel refuses a call it does not take (the wrapper raises)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_plan: no kernel takes {dtype}")
    if d not in HEAD_DIMS or nq < 1 or nk < 1:
        raise ValueError(f"flash_plan: no kernel takes D = {d}, Nq = {nq}, Nk = {nk}")
    if dtype == torch.float32:
        return FlashPlan("simt", 64, 64, *_simt_smem(d))
    if d == 32:
        return FlashPlan("mma_sync", 64, 64, *_mma_sync_smem(d))
    return FlashPlan("wgmma", 128, 128, *_wgmma_smem(d))


def flash_attention_fwd_plain(q, k, v, scale: float):
    """``_fwd_kernel``'s arithmetic in plain PyTorch, all in f32: s = (q
    scale) k^T, p = exp(s - max), out = (p v) / sum p; returns (out in q's
    dtype, lse (B, H, Nq) f32)."""
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = (p @ v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _p_ds_plain(q, k, v, do, lse, delta, scale: float):
    """(q, k, do in f32, p, ds): p = exp(s scale - lse), ds = p (do v^T -
    delta) scale, all in f32."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(scale * (qf @ kf.transpose(-1, -2)) - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) * scale
    return qf, kf, dof, p, ds


def flash_attention_dq_plain(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """``_dq_kernel``'s arithmetic, all in f32: dq = ds k, in q's dtype."""
    _, kf, _, _, ds = _p_ds_plain(q, k, v, do, lse, delta, scale)
    return (ds @ kf).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, scale: float):
    """``_dkv_kernel``'s arithmetic, all in f32: dk = ds^T q, dv = p^T do,
    each in its input's dtype."""
    qf, _, dof, p, ds = _p_ds_plain(q, k, v, do, lse, delta, scale)
    return (ds.transpose(-1, -2) @ qf).to(k.dtype), (p.transpose(-1, -2) @ dof).to(v.dtype)


def flash_attention_bwd_plain(q, k, v, do, lse, delta, scale: float):
    """``_dq_kernel`` and ``_dkv_kernel``'s arithmetic in one pass, all in
    f32: (dq, dk, dv), each in its input's dtype."""
    qf, kf, dof, p, ds = _p_ds_plain(q, k, v, do, lse, delta, scale)
    return ((ds @ kf).to(q.dtype), (ds.transpose(-1, -2) @ qf).to(k.dtype),
            (p.transpose(-1, -2) @ dof).to(v.dtype))


def check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on shapes that are not (B, H, Nq, D), (B, H, Nk, D) twice."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes (B, H, N, D) tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention: empty sequence")


def _check_cuda(tensors: dict[str, torch.Tensor]) -> None:
    """Raise on what the kernel does not take: one CUDA device, f32 or bf16
    throughout, D in HEAD_DIMS, unit stride in D, and for bf16 16-byte
    aligned tiles (the kernel copies them in 16-byte pieces)."""
    q = tensors["q"]
    dtype, dev = q.dtype, q.device
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes f32 or bf16, got {dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel needs D in {HEAD_DIMS}, got D = {q.shape[3]}")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"flash_attention kernel: B*H = {q.shape[0] * q.shape[1]} exceeds the "
                         f"grid's 65535")
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, expected one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel needs unit stride in D of {name}, got "
                             f"strides {t.stride()}")
        if dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"flash_attention bf16 kernel needs {name} 16-byte aligned with "
                             f"batch, head and row strides that are multiples of 8, got strides "
                             f"{t.stride()}")


def _check_stats(lse: torch.Tensor, delta: torch.Tensor, q: torch.Tensor) -> None:
    want = (q.shape[0], q.shape[1], q.shape[2])
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != want or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be a contiguous f32 (B, H, Nq) "
                             f"tensor on q's device, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _empty_like_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B, H, n, D) view of new (B, n, H, D) memory."""
    b, h, _, d = t.shape
    return torch.empty((b, n, h, d), dtype=t.dtype, device=t.device).transpose(1, 2)


def _lib():
    lib = kernels.library("flash_attention")
    if lib.ks_flash_attention_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ks_flash_attention_fwd.argtypes = [p, p, p, i, i, i, i, i, f, i, i, p]
        lib.ks_flash_attention_fwd.restype = i
        for fn in (lib.ks_flash_attention_dq, lib.ks_flash_attention_dkv):
            fn.argtypes = [p, p, p, p, i, i, i, i, i, f, i, i, p]
            fn.restype = i
        lib.ks_flash_attention_smem.argtypes = [i, i, i]
        lib.ks_flash_attention_smem.restype = ctypes.c_longlong
    return lib


def kernel_smem(kernel: str, which: str, d: int) -> int:
    """The dynamic shared memory (bytes) the built kernel ``kernel`` takes
    for ``which`` ("fwd", "dq", "dkv") at head size d, from the library
    itself: what ``flash_plan``'s numbers are held to on the card."""
    return _lib().ks_flash_attention_smem(FLASH_KERNELS[kernel], ("fwd", "dq", "dkv").index(which),
                                          d)


def _shape_args(plan: FlashPlan, q: torch.Tensor, k: torch.Tensor, scale: float) -> tuple:
    b, h, nq, d = q.shape
    return (b, h, nq, k.shape[2], d, float(scale), int(q.dtype == torch.bfloat16),
            FLASH_KERNELS[plan.kernel], kernels.stream_ptr(q))


def _plan_of(q: torch.Tensor, k: torch.Tensor) -> FlashPlan:
    return flash_plan(q.dtype, q.shape[3], q.shape[2], k.shape[2])


def flash_attention_fwd(q, k, v, scale: float):
    """(out, lse): out (B, H, Nq, D) in q's dtype, lse (B, H, Nq) f32."""
    check_layout(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale)
    return launch_fwd(None, q, k, v, scale)


def launch_fwd(plan: FlashPlan | None, q, k, v, scale: float):
    """``flash_attention_fwd`` on the card through ``plan``'s kernel (None:
    the call's own ``flash_plan``); raises when that kernel does not take
    the call (csrc/flash_attention.cu refuses it before any launch)."""
    _check_cuda({"q": q, "k": k, "v": v})
    plan = plan or _plan_of(q, k)
    out = _empty_like_heads(q, q.shape[2])
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.ks_flash_attention_fwd(kernels.pointers(q, k, v, out),
                                     kernels.strides((q, k, v, out), 3), lse.data_ptr(),
                                     *_shape_args(plan, q, k, scale))
    kernels.check(lib, err, f"flash_attention forward {plan.kernel} launch")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.kernel_launches[plan.kernel] += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.kernel_launches = dict.fromkeys(FLASH_KERNELS, 0)


def _check_bwd(q, k, v, do, lse, delta) -> None:
    check_layout(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"flash_attention: do {tuple(do.shape)} != q {tuple(q.shape)}")
    _check_cuda({"q": q, "k": k, "v": v, "do": do})
    _check_stats(lse, delta, q)


def flash_attention_dq(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """dq (B, H, Nq, D) in q's dtype, accumulated over key tiles."""
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, do, lse, delta, scale)
    return launch_dq(None, q, k, v, do, lse, delta, scale)


def launch_dq(plan: FlashPlan | None, q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """``flash_attention_dq`` on the card through ``plan``'s kernel (as
    ``launch_fwd``)."""
    _check_bwd(q, k, v, do, lse, delta)
    plan = plan or _plan_of(q, k)
    dq = _empty_like_heads(q, q.shape[2])
    lib = _lib()
    err = lib.ks_flash_attention_dq(kernels.pointers(q, k, v, do, dq),
                                    kernels.strides((q, k, v, do, dq), 3), lse.data_ptr(),
                                    delta.data_ptr(), *_shape_args(plan, q, k, scale))
    kernels.check(lib, err, f"flash_attention dq {plan.kernel} launch")
    flash_attention_dq.launches += 1
    flash_attention_dq.kernel_launches[plan.kernel] += 1
    return dq


flash_attention_dq.launches = 0
flash_attention_dq.kernel_launches = dict.fromkeys(FLASH_KERNELS, 0)


def flash_attention_dkv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv), each (B, H, Nk, D) in its input's dtype, accumulated over
    query tiles."""
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, scale)
    return launch_dkv(None, q, k, v, do, lse, delta, scale)


def launch_dkv(plan: FlashPlan | None, q, k, v, do, lse, delta, scale: float):
    """``flash_attention_dkv`` on the card through ``plan``'s kernel (as
    ``launch_fwd``)."""
    _check_bwd(q, k, v, do, lse, delta)
    plan = plan or _plan_of(q, k)
    dk = _empty_like_heads(k, k.shape[2])
    dv = _empty_like_heads(v, v.shape[2])
    lib = _lib()
    err = lib.ks_flash_attention_dkv(kernels.pointers(q, k, v, do, dk, dv),
                                     kernels.strides((q, k, v, do, dk, dv), 3), lse.data_ptr(),
                                     delta.data_ptr(), *_shape_args(plan, q, k, scale))
    kernels.check(lib, err, f"flash_attention dk/dv {plan.kernel} launch")
    flash_attention_dkv.launches += 1
    flash_attention_dkv.kernel_launches[plan.kernel] += 1
    return dk, dv


flash_attention_dkv.launches = 0
flash_attention_dkv.kernel_launches = dict.fromkeys(FLASH_KERNELS, 0)


def flash_attention_bwd(q, k, v, do, lse, delta, scale: float):
    """(dq, dk, dv) from do (B, H, Nq, D) and the caller's f32 (B, H, Nq) lse
    and delta: the JAX ``flash_bwd`` signature (its block sizes aside)."""
    check_layout(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, scale)
    dq = flash_attention_dq(q, k, v, do, lse, delta, scale)
    return (dq, *flash_attention_dkv(q, k, v, do, lse, delta, scale))


def flash_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = sum_d(do * out), (B, H, N) f32 like lse (``_flash_vjp_bwd``):
    the product of the f32 values, summed in f32 (one new f32 copy of do,
    which the product overwrites)."""
    return do.to(torch.float32, copy=True).mul_(out).sum(-1).contiguous()


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, flash_delta(do, out), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Multi-head flash attention on (B, H, N, D); returns (B, H, N, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, scale)
