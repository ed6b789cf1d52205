"""Attention of the transformer zoo; counterpart of
``kurosiwo_tpu/ops/attention.py``.

Routing of ``attention_packed`` (the JAX package's ``:105-129``):
  * the flash route, N and Nk >= 1024 with a 128-multiple block: the flash
    kernel is not ported yet, so it raises (ROADMAP.md, B5);
  * D in {32, 64, 128} and H*D % 128 == 0: the packed-layout short-sequence
    kernel (``ops/short_attention.py``), on every device; a CPU tensor goes
    through its plain version;
  * anything else: plain einsum attention with f32 scores, as the JAX
    package's fallback.
"""

from __future__ import annotations

import torch

from .short_attention import HEAD_DIMS, short_attention

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


def _flash_not_ported():
    raise NotImplementedError(
        "flash attention (N and Nk >= 1024 with a 128-multiple block) is not ported yet "
        "(ROADMAP.md, B5)")


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
        _flash_not_ported()
    return _einsum_attention(q, k, v, scale)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                     scale: float | None = None) -> torch.Tensor:
    """Multi-head attention on packed (B, N, H*D) tensors -> (B, N, H*D)."""
    b, n, inner = q.shape
    d = inner // heads
    if scale is None:
        scale = d**-0.5
    if _flash_route(n, k.shape[1]):
        _flash_not_ported()
    if d in HEAD_DIMS and inner % 128 == 0:
        return short_attention(q, k, v, heads, scale)
    split = lambda t: t.reshape(b, t.shape[1], heads, d).transpose(1, 2)
    out = _einsum_attention(split(q), split(k), split(v), scale)
    return out.transpose(1, 2).reshape(b, n, inner)
