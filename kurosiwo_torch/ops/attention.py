"""Attention of the transformer zoo; counterpart of
``kurosiwo_tpu/ops/attention.py``.

Routing (the JAX package's ``:55-79`` and ``:105-129``), by shape alone:
  * the flash route, N and Nk >= 1024 with a 128-multiple block: the flash
    kernel (``ops/flash_attention.py``, B5) for ``attention`` and
    ``attention_packed`` alike; the packed tensors go in as (B, H, N, D)
    views and its output comes back as a view of (B, N, H*D) memory, with
    no copy on the card; a CPU tensor goes through its plain version;
  * D in {32, 64, 128} and H*D % 128 == 0: the packed-layout short-sequence
    kernel (``ops/short_attention.py``), on every device; a CPU tensor goes
    through its plain version;
  * anything else: plain einsum attention with f32 scores, as the JAX
    package's fallback.

``attention_qkv`` takes the packed qkv projection (B, N, 3*H*D) whole: on
the short route its custom VJP (``short_attention_qkv``) writes dq, dk and
dv into the thirds of one qkv gradient; the flash and einsum routes take
the thirds as ``attention_packed`` does. ``attention_packed``'s short route
(``short_attention``, separate q, k, v) is for attention whose q and k/v
come from different projections: the change-detection transformers'
cross-attention and reduced keys (ROADMAP A6).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .short_attention import HEAD_DIMS, _heads_view, short_attention, short_attention_qkv

_FLASH_MIN_SEQ = 1024


def _pick_block(n: int, want: int = 256) -> int | None:
    """Largest 128-multiple block <= want that divides n; None when n has no
    such divisor."""
    b = min(want, n)
    b -= b % 128
    while b >= 128:
        if n % b == 0:
            return b
        b -= 128
    return None


def _flash_route(n: int, nk: int) -> bool:
    return (n >= _FLASH_MIN_SEQ and nk >= _FLASH_MIN_SEQ
            and _pick_block(n) is not None and _pick_block(nk) is not None)


def _short_route(n: int, nk: int, d: int, inner: int) -> bool:
    """Whether packed attention of Nq = n, Nk = nk, D = d, H*D = inner takes
    the short-sequence kernel: not the flash route, and a D and H*D it takes."""
    return not _flash_route(n, nk) and d in HEAD_DIMS and inner % 128 == 0


def _einsum_attention(q, k, v, scale):
    """(B, H, N, D) attention with f32 scores and softmax; the probabilities
    are rounded to q's dtype before the PV product (f32 accumulation)."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float | None = None) -> torch.Tensor:
    """Multi-head attention on (B, H, N, D) tensors; returns (B, H, N, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _flash_route(q.shape[-2], k.shape[-2]):
        return flash_attention(q, k, v, scale)
    return _einsum_attention(q, k, v, scale)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                     scale: float | None = None) -> torch.Tensor:
    """Multi-head attention on packed (B, N, H*D) tensors -> (B, N, H*D)."""
    b, n, inner = q.shape
    d = inner // heads
    if scale is None:
        scale = d**-0.5
    if _flash_route(n, k.shape[1]):
        out = flash_attention(_heads_view(q, heads), _heads_view(k, heads), _heads_view(v, heads),
                              scale)
        return out.transpose(1, 2).reshape(b, n, inner)
    if _short_route(n, k.shape[1], d, inner):
        return short_attention(q, k, v, heads, scale)
    out = _einsum_attention(_heads_view(q, heads), _heads_view(k, heads), _heads_view(v, heads),
                            scale)
    return out.transpose(1, 2).reshape(b, n, inner)


def attention_qkv(qkv: torch.Tensor, heads: int, scale: float | None = None) -> torch.Tensor:
    """Multi-head self-attention on the packed projection (B, N, 3*H*D),
    q, k, v its column-thirds -> (B, N, H*D)."""
    n, inner = qkv.shape[1], qkv.shape[-1] // 3
    d = inner // heads
    if _short_route(n, n, d, inner):
        return short_attention_qkv(qkv, heads, d**-0.5 if scale is None else scale)
    return attention_packed(*qkv.chunk(3, dim=-1), heads, scale)
