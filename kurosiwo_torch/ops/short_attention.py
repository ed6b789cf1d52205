"""Short-sequence multi-head attention on the packed (B, N, H*D) layout,
forward and backward, through the hand-written kernel
``csrc/short_attention.cu``.

Counterpart of the short part of ``kurosiwo_tpu/ops/pallas_attention.py``:
``short_attention_fwd`` replaces ``_short_fwd_kernel`` and
``short_attention_bwd`` replaces ``_short_bwd_kernel``; ``short_attention``
is the custom VJP (residuals q, k, v, out, lse, as ``_short_vjp_fwd``), with
delta = sum_d(do * out) computed in plain PyTorch between them, as the JAX
package computes it outside its kernel.

Layout: q (B, Nq, H*D), k and v (B, Nk, H*D), each with unit stride in its
last axis and any batch and row strides, so the three column-thirds of a
qkv projection go in as views with no copy. Outputs are contiguous: out and
dq (B, Nq, H*D), dk and dv (B, Nk, H*D) in the input dtype, lse (B, H, Nq)
f32. The kernel takes f32 or bf16, D in {32, 64, 128} and H*D % 128 == 0.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises. ``.launches`` counts kernel wrapper calls.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

HEAD_DIMS = (32, 64, 128)


def _heads_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H*D) -> (B, H, N, D) view."""
    b, n, hd = t.shape
    return t.reshape(b, n, heads, hd // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H*D)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def short_attention_fwd_plain(q, k, v, heads: int, scale: float):
    """The TPU kernel's arithmetic in plain PyTorch: scores in f32, softmax
    in f32, p/l rounded to v's dtype before the PV product (f32
    accumulation); returns (out in q's dtype, lse (B, H, Nq) f32)."""
    qh, kh, vh = (_heads_view(t, heads).float() for t in (q, k, v))
    s = scale * (qh @ kh.transpose(-1, -2))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p / l).to(v.dtype).float() @ vh
    return _merge_heads(o.to(q.dtype)), (m + torch.log(l))[..., 0]


def short_attention_bwd_plain(q, k, v, do, lse, delta, heads: int, scale: float):
    """The TPU backward kernel's arithmetic: p = exp(s - lse) rounded to
    do's dtype for dv, ds = p (dp - delta) scale rounded to q's dtype for dq
    and dk, f32 accumulation; returns (dq, dk, dv) in the inputs' dtypes."""
    qh, kh, vh, doh = (_heads_view(t, heads).float() for t in (q, k, v, do))
    s = scale * (qh @ kh.transpose(-1, -2))
    p = torch.exp(s - lse[..., None])
    dv = p.to(do.dtype).float().transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    return _merge_heads(dq.to(q.dtype)), _merge_heads(dk.to(k.dtype)), _merge_heads(dv.to(v.dtype))


def check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> int:
    """Raise on what the kernel does not take; returns D."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"short_attention takes packed (B, N, H*D) tensors, got {q.shape}, "
                         f"{k.shape}, {v.shape}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"short_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    hd = q.shape[2]
    if heads <= 0 or hd % heads:
        raise ValueError(f"short_attention: H*D = {hd} is not a multiple of heads = {heads}")
    d = hd // heads
    if d not in HEAD_DIMS or hd % 128:
        raise ValueError(f"short_attention kernel needs D in {HEAD_DIMS} and H*D % 128 == 0, "
                         f"got D = {d}, H*D = {hd}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("short_attention: empty sequence")
    return d


def _check_cuda(tensors: dict[str, torch.Tensor], dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"short_attention kernel takes f32 or bf16, got {dtype}")
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"short_attention: {name} is on {t.device}, expected one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"short_attention: {name} is {t.dtype}, q is {dtype}")
        if t.stride(2) != 1:
            raise ValueError(f"short_attention kernel needs unit stride in the last axis of "
                             f"{name}, got strides {t.stride()}")
        # the bf16 kernel copies tiles in 16-byte pieces
        if dtype == torch.bfloat16 and (t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8):
            raise ValueError(f"short_attention bf16 kernel needs {name} 16-byte aligned with "
                             f"batch and row strides that are multiples of 8, got strides "
                             f"{t.stride()}")


def _strides(*ts: torch.Tensor) -> ctypes.Array:
    flat = [s for t in ts for s in (t.stride(0), t.stride(1))]
    return (ctypes.c_longlong * len(flat))(*flat)


def _pointers(*ts: torch.Tensor) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _lib():
    lib = kernels.library("short_attention")
    if lib.ks_short_attention_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ks_short_attention_fwd.argtypes = [p, p, p, i, i, i, i, i, f, i, p]
        lib.ks_short_attention_fwd.restype = i
        lib.ks_short_attention_bwd.argtypes = [p, p, p, p, i, i, i, i, i, f, i, p]
        lib.ks_short_attention_bwd.restype = i
    return lib


def _grid_limit(b: int, heads: int) -> None:
    if b * heads > 65535:
        raise ValueError(f"short_attention kernel: B*H = {b * heads} exceeds the grid's 65535")


def short_attention_fwd(q, k, v, heads: int, scale: float):
    """(out, lse): out (B, Nq, H*D) in q's dtype, lse (B, H, Nq) f32."""
    d = check_layout(q, k, v, heads)
    if q.device.type == "cpu":
        return short_attention_fwd_plain(q, k, v, heads, scale)
    _check_cuda({"q": q, "k": k, "v": v}, q.dtype)
    b, nq, hd = q.shape
    nk = k.shape[1]
    _grid_limit(b, heads)
    out = torch.empty((b, nq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, heads, nq), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.ks_short_attention_fwd(
        _pointers(q, k, v, out), _strides(q, k, v, out), lse.data_ptr(), b, heads, nq, nk, d,
        float(scale), int(q.dtype == torch.bfloat16), kernels.stream_ptr(q))
    kernels.check(lib, err, "short_attention forward launch")
    short_attention_fwd.launches += 1
    return out, lse


short_attention_fwd.launches = 0


def short_attention_bwd(q, k, v, do, lse, delta, heads: int, scale: float):
    """(dq, dk, dv) in the inputs' dtypes from do (B, Nq, H*D) and the f32
    (B, H, Nq) lse and delta. One call is two kernel launches (dk/dv over
    key tiles, then dq over query tiles)."""
    d = check_layout(q, k, v, heads)
    if q.device.type == "cpu":
        return short_attention_bwd_plain(q, k, v, do, lse, delta, heads, scale)
    _check_cuda({"q": q, "k": k, "v": v, "do": do}, q.dtype)
    if do.shape != q.shape:
        raise ValueError(f"short_attention: do {tuple(do.shape)} != q {tuple(q.shape)}")
    b, nq, hd = q.shape
    nk = k.shape[1]
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, heads, nq) or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"short_attention: {name} must be a contiguous f32 (B, H, Nq) "
                             f"tensor on q's device, got {t.dtype} {tuple(t.shape)}")
    _grid_limit(b, heads)
    dq = torch.empty((b, nq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, nk, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, nk, hd), dtype=v.dtype, device=q.device)
    lib = _lib()
    err = lib.ks_short_attention_bwd(
        _pointers(q, k, v, do, dq, dk, dv), _strides(q, k, v, do, dq, dk, dv), lse.data_ptr(),
        delta.data_ptr(), b, heads, nq, nk, d, float(scale), int(q.dtype == torch.bfloat16),
        kernels.stream_ptr(q))
    kernels.check(lib, err, "short_attention backward launch")
    short_attention_bwd.launches += 1
    return dq, dk, dv


short_attention_bwd.launches = 0


def attention_delta(do: torch.Tensor, out: torch.Tensor, heads: int) -> torch.Tensor:
    """delta = sum_d(do * out) per head, (B, H, N) f32 like lse
    (``_short_vjp_bwd``, pallas_attention.py:385-386)."""
    b, n, hd = out.shape
    prod = do.float() * out.float()
    return prod.reshape(b, n, heads, hd // heads).sum(-1).transpose(1, 2).contiguous()


class _ShortAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        out, lse = short_attention_fwd(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = attention_delta(do, out, ctx.heads)
        dq, dk, dv = short_attention_bwd(q, k, v, do, lse, delta, ctx.heads, ctx.scale)
        return dq, dk, dv, None, None


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                    scale: float | None = None) -> torch.Tensor:
    """Multi-head attention on packed (B, N, H*D) tensors -> (B, N, H*D)."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    return _ShortAttention.apply(q, k, v, heads, scale)
