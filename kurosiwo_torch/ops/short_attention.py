"""Short-sequence multi-head attention on the packed (B, N, H*D) layout,
forward and backward, through the hand-written kernels of
``csrc/short_attention.cu`` and, for long queries over short keys,
``csrc/long_attention.cu`` (B4).

Counterpart of the short part of ``kurosiwo_tpu/ops/pallas_attention.py``:
``short_attention_fwd`` replaces ``_short_fwd_kernel`` and
``short_attention_bwd`` replaces ``_short_bwd_kernel``. ``short_attention``
is the custom VJP on q, k and v (residuals q, k, v, out, lse, as
``_short_vjp_fwd``); ``short_attention_qkv`` the same on the packed qkv
projection, whose backward returns the qkv gradient with dq, dk and dv
written into its three column-thirds (no concat). delta = sum_d(do * out)
(``_short_vjp_bwd``) is computed inside the wgmma and wgmma_long kernels,
and in plain PyTorch (``attention_delta``) for the other kernels and the
plain version.

Layout: q (B, Nq, H*D), k and v (B, Nk, H*D), each with unit stride in its
last axis and any batch and row strides, so the three column-thirds of a
qkv projection go in as views with no copy. out and lse are new and
contiguous: out (B, Nq, H*D) in the input dtype, lse (B, H, Nq) f32. dq, dk
and dv are new contiguous tensors, or the caller's views (``dq=``, ``dk=``,
``dv=``, e.g. the thirds of one qkv gradient), with the inputs' layout
rules. The kernels take f32 or bf16, D in {32, 64, 128} and H*D % 128 == 0.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel that ``short_plan`` names for the call's dtype and shape
or raises: bf16 at D 64 with Nq, Nk <= 256 (and at D 128 with Nq <= 256, Nk
<= 128) runs the Hopper kernels that hold a head whole (``wgmma``); bf16 at
D 64 with Nq > 256 over 1-64 keys (BiT-CD's decoder, ChangeFormer's stage
2) the Hopper kernels for long queries over short keys (``wgmma_long``,
units of (batch, head, chunk of query tiles): ``long_chunk``); other bf16
calls the mma.sync ones, f32 the CUDA-core ones. ``.launches`` counts
kernel wrapper calls, ``.kernel_launches`` them by kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import kernels

HEAD_DIMS = (32, 64, 128)
# the kernels, by their Kernel number in csrc/short_attention.cu (wgmma_long:
# csrc/long_attention.cu's, which has its own entry points)
SHORT_KERNELS = {"simt": 0, "mma_sync": 1, "wgmma": 2, "wgmma_long": 3}
SMEM_LIMIT = 232448  # dynamic shared memory one block may take on an H100 (227 KB)
WGMMA_MAX_ROWS = 256  # the longest head (queries or keys) the wgmma kernels hold whole
LONG_MAX_KEYS = 64  # the most keys the wgmma_long kernels take
SMS = 132  # streaming multiprocessors of an H100 SXM
LONG_WAVES = 2  # units a launch of wgmma_long gives each resident block, at least


class ShortPlan(NamedTuple):
    kernel: str            # a key of SHORT_KERNELS
    fwd_threads: int       # threads of a block
    bwd_threads: int
    fwd_smem: int          # dynamic shared memory of a block, bytes (the larger of the
    bwd_smem: int          # two backward kernels of simt and mma_sync)


def _tiles(n: int) -> int:
    return -(-n // 64)


def _simt_smem(d: int) -> tuple[int, int]:
    tile, score = 4 * 64 * (d + 1), 4 * 64 * 65
    return 3 * tile + score, 4 * tile + 2 * score + 2 * 64 * 4


def _mma_sync_smem(d: int) -> tuple[int, int]:
    tile = 2 * 64 * (d + 8)
    return 3 * tile, 4 * tile + 2 * 64 * 4


def _fwd_stage(d: int, nq: int, nk: int) -> int:
    return (_tiles(nq) + 2 * _tiles(nk)) * 64 * d * 2 + 8


def wgmma_fwd_stages(d: int, nq: int, nk: int) -> int:
    """Item stages of csrc/short_attention.cu's forward: two (resident
    blocks walk the items with the next item's copies in flight) where they
    fit, else one (one block an item)."""
    return 2 if 2 * _fwd_stage(d, nq, nk) + 1024 <= SMEM_LIMIT else 1


def wgmma_fwd_smem(d: int, nq: int, nk: int) -> int:
    """csrc/short_attention.cu's forward: per item stage the Q tiles, K and
    V tiles (64 rows x 2 d bytes each, B128) and one mbarrier; 1 KB of
    alignment slack."""
    return wgmma_fwd_stages(d, nq, nk) * _fwd_stage(d, nq, nk) + 1024


def _bwd_shape(d: int, nk: int) -> tuple[int, int]:
    """(consumer warpgroups, 64-key tiles each) of the wgmma backward."""
    nkt = _tiles(nk)
    if d == 128:
        return 2, 1
    return (1, 1) if nkt == 1 else (2, 1) if nkt == 2 else (2, 2)


def wgmma_bwd_smem(d: int, nk: int) -> int:
    """csrc/short_attention.cu's BwdLayout: K and V of an item (two item
    stages where they fit), a ring of two (Q, dO, out) tile stages, dS^T
    ([keys][64 queries] bf16), lse and delta per ring stage, 10 mbarriers,
    1 KB of alignment slack."""
    nwg, kt = _bwd_shape(d, nk)
    tile = 64 * d * 2
    kv = 2 * nwg * kt * tile
    fixed = 2 * (3 * tile + 512) + nwg * kt * 64 * 128 + 8 * 10 + 1024
    return (2 if 2 * kv + fixed <= SMEM_LIMIT else 1) * kv + fixed


def wgmma_takes(d: int, nq: int, nk: int) -> bool:
    """Whether the wgmma kernels take a bf16 call: a head held whole (Nq, Nk
    <= 256); D 128 holds a warpgroup's dK and dV of 64 keys in registers, so
    two warpgroups take Nk <= 128."""
    return (1 <= nq <= WGMMA_MAX_ROWS and 1 <= nk
            and ((d == 64 and nk <= WGMMA_MAX_ROWS) or (d == 128 and nk <= 128)))


def long_route(d: int, nq: int, nk: int) -> bool:
    """Whether a bf16 call takes the wgmma_long kernels: D 64, a head too
    long to hold whole (Nq > 256) over 1-64 keys."""
    return d == 64 and nq > WGMMA_MAX_ROWS and 1 <= nk <= LONG_MAX_KEYS


def _keys16(nk: int) -> int:
    return -(-nk // 16) * 16


def long_fwd_smem() -> int:
    """csrc/long_attention.cu's LongLayout, forward: K and V tiles, a ring
    of three Q tiles, the out tile of the TMA store (8 KB each), four
    mbarriers, 1 KB of alignment slack."""
    return 6 * 8192 + 8 * 4 + 1024


def long_bwd_smem(nk: int) -> int:
    """The backward: K and V tiles, a ring of two (Q, dO, out) stages, P^T
    and dS^T ([keys rounded up to 16][64 queries] bf16), three mbarriers,
    1 KB of alignment slack."""
    return 8 * 8192 + 2 * _keys16(nk) * 128 + 8 * 3 + 1024


def long_blocks(which: str, nk: int) -> int:
    """Blocks one SM holds (the kernels' __launch_bounds__): four forward
    blocks, three backward ones up to 32 keys, else two (the registers of
    dK^T, dV^T, S and dP at 64 keys)."""
    return 4 if which == "fwd" else 3 if _keys16(nk) <= 32 else 2


def long_chunk(which: str, nq: int, nk: int, items: int) -> int:
    """Query tiles of one wgmma_long unit, for ``items`` (batch, head)
    pairs: each item cut into the fewest chunks that give every resident
    block (``long_blocks`` on SMS) LONG_WAVES units. A unit is (item, chunk
    c), tiles [c * chunk, min((c + 1) * chunk, ceil(Nq / 64))); the backward
    sums its units' dK and dV partials in chunk order. A pure function of
    the call's shape, so a call's result is too."""
    nqt = _tiles(nq)
    want = LONG_WAVES * SMS * long_blocks(which, nk)
    per_item = min(nqt, max(1, -(-want // items)))
    return -(-nqt // per_item)


@functools.lru_cache(maxsize=None)
def short_plan(dtype: torch.dtype, d: int, nq: int, nk: int) -> ShortPlan:
    """The csrc/short_attention.cu kernels of one call: f32 the CUDA-core
    kernels; bf16 the Hopper kernels (wgmma fed by TMA, one (batch, head)
    item held whole a block, blocks resident and walking the items) where
    ``wgmma_takes``; the Hopper kernels for long queries over short keys
    where ``long_route``; else the mma.sync kernels (Nk > 256, Nk > 64 with
    Nq > 256, D 32, D 128 with Nq > 256 or Nk > 128). The kernel refuses a
    call it does not take (the wrapper raises)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"short_plan: no kernel takes {dtype}")
    if d not in HEAD_DIMS or nq < 1 or nk < 1:
        raise ValueError(f"short_plan: no kernel takes D = {d}, Nq = {nq}, Nk = {nk}")
    if dtype == torch.float32:
        return ShortPlan("simt", 256, 256, *_simt_smem(d))
    if long_route(d, nq, nk):
        return ShortPlan("wgmma_long", 128, 128, long_fwd_smem(), long_bwd_smem(nk))
    if not wgmma_takes(d, nq, nk):
        return ShortPlan("mma_sync", 128, 128, *_mma_sync_smem(d))
    return ShortPlan("wgmma", 256 if _tiles(nq) > 1 else 128, 128 * (_bwd_shape(d, nk)[0] + 1),
                     wgmma_fwd_smem(d, nq, nk), wgmma_bwd_smem(d, nk))


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
        # the bf16 kernels copy tiles in 16-byte pieces (TMA boxes for wgmma)
        if dtype == torch.bfloat16 and (t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8):
            raise ValueError(f"short_attention bf16 kernel needs {name} 16-byte aligned with "
                             f"batch and row strides that are multiples of 8, got strides "
                             f"{t.stride()}")


def _lib():
    lib = kernels.library("short_attention")
    if lib.ks_short_attention_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ks_short_attention_fwd.argtypes = [p, p, p, i, i, i, i, i, f, i, i, p]
        lib.ks_short_attention_fwd.restype = i
        lib.ks_short_attention_bwd.argtypes = [p, p, p, p, i, i, i, i, i, f, i, i, p]
        lib.ks_short_attention_bwd.restype = i
        lib.ks_short_attention_footprint.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.ks_short_attention_footprint.restype = ctypes.c_longlong
    return lib


def _long_lib():
    lib = kernels.library("long_attention")
    if lib.ks_long_attention_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ks_long_attention_fwd.argtypes = [p, p, p, i, i, i, i, i, f, i, i, p]
        lib.ks_long_attention_fwd.restype = i
        lib.ks_long_attention_bwd.argtypes = [p, p, p, p, i, i, i, i, i, f, i, i, p]
        lib.ks_long_attention_bwd.restype = i
        lib.ks_long_attention_footprint.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        lib.ks_long_attention_footprint.restype = ctypes.c_longlong
    return lib


def kernel_footprint(which: str, d: int, nq: int, nk: int) -> tuple[int, int]:
    """(dynamic shared memory of a block in bytes, blocks one SM holds) of
    the built wgmma or wgmma_long kernel for ``which`` ("fwd", "bwd") of a
    call (as ``short_plan`` routes it), from the library itself: what
    ``short_plan``'s numbers are held to on the card."""
    blocks = ctypes.c_int(0)
    if long_route(d, nq, nk):
        smem = _long_lib().ks_long_attention_footprint(("fwd", "bwd").index(which), nk,
                                                       ctypes.byref(blocks))
    else:
        smem = _lib().ks_short_attention_footprint(("fwd", "bwd").index(which), d, nq, nk,
                                                   ctypes.byref(blocks))
    return smem, blocks.value


def _grid_limit(b: int, heads: int) -> None:
    if b * heads > 65535:
        raise ValueError(f"short_attention kernel: B*H = {b * heads} exceeds the grid's 65535")


def _plan_of(q: torch.Tensor, k: torch.Tensor, heads: int) -> ShortPlan:
    return short_plan(q.dtype, q.shape[2] // heads, q.shape[1], k.shape[1])


def short_attention_fwd(q, k, v, heads: int, scale: float):
    """(out, lse): out (B, Nq, H*D) in q's dtype, lse (B, H, Nq) f32."""
    check_layout(q, k, v, heads)
    if q.device.type == "cpu":
        return short_attention_fwd_plain(q, k, v, heads, scale)
    return launch_fwd(None, q, k, v, heads, scale)


def launch_fwd(plan: ShortPlan | None, q, k, v, heads: int, scale: float):
    """``short_attention_fwd`` on the card through ``plan``'s kernel (None:
    the call's own ``short_plan``); raises when that kernel does not take
    the call (csrc/short_attention.cu refuses it before any launch)."""
    d = check_layout(q, k, v, heads)
    _check_cuda({"q": q, "k": k, "v": v}, q.dtype)
    plan = plan or _plan_of(q, k, heads)
    b, nq, hd = q.shape
    nk = k.shape[1]
    _grid_limit(b, heads)
    out = torch.empty((b, nq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, heads, nq), dtype=torch.float32, device=q.device)
    long = plan.kernel == "wgmma_long"
    lib = _long_lib() if long else _lib()
    if long:
        err = lib.ks_long_attention_fwd(
            kernels.pointers(q, k, v, out), kernels.strides((q, k, v, out), 2), lse.data_ptr(),
            b, heads, nq, nk, d, float(scale), int(q.dtype == torch.bfloat16),
            long_chunk("fwd", nq, nk, b * heads), kernels.stream_ptr(q))
    else:
        err = lib.ks_short_attention_fwd(
            kernels.pointers(q, k, v, out), kernels.strides((q, k, v, out), 2), lse.data_ptr(),
            b, heads, nq, nk, d, float(scale), int(q.dtype == torch.bfloat16),
            SHORT_KERNELS[plan.kernel], kernels.stream_ptr(q))
    kernels.check(lib, err, f"short_attention forward {plan.kernel} launch")
    short_attention_fwd.launches += 1
    short_attention_fwd.kernel_launches[plan.kernel] += 1
    return out, lse


short_attention_fwd.launches = 0
short_attention_fwd.kernel_launches = dict.fromkeys(SHORT_KERNELS, 0)


def _outputs(q, k, dq, dk, dv):
    """The gradient tensors: the caller's views, or new contiguous ones."""
    new = lambda t, like: torch.empty(like.shape, dtype=like.dtype, device=like.device) \
        if t is None else t
    got = (new(dq, q), new(dk, k), new(dv, k))
    for name, t, like in zip(("dq", "dk", "dv"), got, (q, k, k)):
        if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
            raise ValueError(f"short_attention: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {like.dtype} {tuple(like.shape)} on "
                             f"{like.device}")
    return got


def short_attention_bwd(q, k, v, do, lse, out, heads: int, scale: float, dq=None, dk=None,
                        dv=None):
    """(dq, dk, dv) in the inputs' dtypes from do (B, Nq, H*D), the
    forward's out and its f32 (B, H, Nq) lse. The wgmma and wgmma_long
    kernels compute delta = sum_d(do * out) themselves; the other kernels and
    the plain version take it from ``attention_delta``. ``dq``, ``dk``, ``dv``: views to write the
    gradients into (new tensors where None)."""
    check_layout(q, k, v, heads)
    if q.device.type == "cpu":
        got = short_attention_bwd_plain(q, k, v, do, lse, attention_delta(do, out, heads), heads,
                                        scale)
        if dq is dk is dv is None:
            return got
        return tuple(t.copy_(g) for t, g in zip(_outputs(q, k, dq, dk, dv), got))
    return launch_bwd(None, q, k, v, do, lse, out, heads, scale, dq, dk, dv)


def launch_bwd(plan: ShortPlan | None, q, k, v, do, lse, out, heads: int, scale: float,
               dq=None, dk=None, dv=None):
    """``short_attention_bwd`` on the card through ``plan``'s kernel (as
    ``launch_fwd``). One call is one launch (wgmma) or two: wgmma_long's
    fused kernel, then the fixed-order sum of its units' dk/dv partials (f32
    scratch from here); simt's and mma_sync's dk/dv over key tiles, then dq
    over query tiles, after ``attention_delta``."""
    d = check_layout(q, k, v, heads)
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"short_attention: do {tuple(do.shape)}, out {tuple(out.shape)} != q "
                         f"{tuple(q.shape)}")
    dq, dk, dv = _outputs(q, k, dq, dk, dv)
    _check_cuda({"q": q, "k": k, "v": v, "do": do, "out": out, "dq": dq, "dk": dk, "dv": dv},
                q.dtype)
    plan = plan or _plan_of(q, k, heads)
    b, nq, _ = q.shape
    nk = k.shape[1]
    if lse.dtype != torch.float32 or lse.shape != (b, heads, nq) or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"short_attention: lse must be a contiguous f32 (B, H, Nq) tensor on "
                         f"q's device, got {lse.dtype} {tuple(lse.shape)}")
    _grid_limit(b, heads)
    long = plan.kernel == "wgmma_long"
    lib = _long_lib() if long else _lib()
    ptrs = kernels.pointers(q, k, v, do, out, dq, dk, dv)
    strides = kernels.strides((q, k, v, do, out, dq, dk, dv), 2)
    if long:
        chunk = long_chunk("bwd", nq, nk, b * heads)
        part = torch.empty(b * heads * -(-_tiles(nq) // chunk) * 2 * nk * d,
                           dtype=torch.float32, device=q.device)
        err = lib.ks_long_attention_bwd(ptrs, strides, lse.data_ptr(), part.data_ptr(), b, heads,
                                        nq, nk, d, float(scale), int(q.dtype == torch.bfloat16),
                                        chunk, kernels.stream_ptr(q))
    else:
        delta = None if plan.kernel == "wgmma" else attention_delta(do, out, heads)
        err = lib.ks_short_attention_bwd(
            ptrs, strides, lse.data_ptr(), None if delta is None else delta.data_ptr(), b,
            heads, nq, nk, d, float(scale), int(q.dtype == torch.bfloat16),
            SHORT_KERNELS[plan.kernel], kernels.stream_ptr(q))
    kernels.check(lib, err, f"short_attention backward {plan.kernel} launch")
    short_attention_bwd.launches += 1
    short_attention_bwd.kernel_launches[plan.kernel] += 1
    return dq, dk, dv


short_attention_bwd.launches = 0
short_attention_bwd.kernel_launches = dict.fromkeys(SHORT_KERNELS, 0)


def attention_delta(do: torch.Tensor, out: torch.Tensor, heads: int) -> torch.Tensor:
    """delta = sum_d(do * out) per head, (B, H, N) f32 like lse
    (``_short_vjp_bwd``, pallas_attention.py:385-386)."""
    b, n, hd = out.shape
    prod = do.float() * out.float()
    return prod.reshape(b, n, heads, hd // heads).sum(-1).transpose(1, 2).contiguous()


def _unit_stride(do: torch.Tensor) -> torch.Tensor:
    return do if do.stride(-1) == 1 else do.contiguous()


class _ShortAttention(torch.autograd.Function):
    """Attention on separate q, k and v (``attention_packed``'s short route):
    the route of attention whose q and k/v come from different projections,
    as BiT-CD's cross-attention (the decoder's pixels over its tokens) and
    ChangeFormer's reduced keys; self-attention on one qkv projection takes
    ``_ShortAttentionQKV``."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        out, lse = short_attention_fwd(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = short_attention_bwd(q, k, v, _unit_stride(do), lse, out, ctx.heads,
                                         ctx.scale)
        return dq, dk, dv, None, None


class _ShortAttentionQKV(torch.autograd.Function):
    """Attention on the packed qkv projection (B, N, 3*H*D): q, k and v are
    its column-thirds, read in place; the backward writes dq, dk and dv into
    the thirds of one new qkv gradient, so autograd has no split or concat."""

    @staticmethod
    def forward(ctx, qkv, heads, scale):
        q, k, v = qkv.chunk(3, dim=-1)
        out, lse = short_attention_fwd(q, k, v, heads, scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        short_attention_bwd(*qkv.chunk(3, dim=-1), _unit_stride(do), lse, out, ctx.heads,
                            ctx.scale, *dqkv.chunk(3, dim=-1))
        return dqkv, None, None


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                    scale: float | None = None) -> torch.Tensor:
    """Multi-head attention on packed (B, N, H*D) tensors -> (B, N, H*D)."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    return _ShortAttention.apply(q, k, v, heads, scale)


def short_attention_qkv(qkv: torch.Tensor, heads: int, scale: float | None = None) -> torch.Tensor:
    """Multi-head self-attention on the packed projection (B, N, 3*H*D) ->
    (B, N, H*D); q, k, v are its column-thirds, in that order."""
    if scale is None:
        scale = (qkv.shape[-1] // 3 // heads) ** -0.5
    return _ShortAttentionQKV.apply(qkv, heads, scale)
