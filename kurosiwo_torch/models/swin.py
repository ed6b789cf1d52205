"""Swin Transformer backbone (tiny, small, base) of UperNet; counterpart of
``kurosiwo_tpu/models/swin.py`` (``window_partition``, ``window_reverse``,
``_relative_position_index``, ``_shift_mask``, ``WindowAttention``,
``SwinBlock``, ``SwinTransformer``, ``:25-153``).

Window attention runs as (B * windows, heads, 49, 49) batched products in
plain torch, as the JAX package computes it outside any Pallas kernel (an
einsum, not ``attention_packed``): f32 scores, the relative-position bias
and the shift mask added, the softmax's probabilities rounded to the
compute dtype before the product with V (f32 accumulation). The window is
min(7, h, w); the cyclic shift (``torch.roll``) is used only at the full
window, also where one window covers the map (stage 4 at 224x224). The
shift mask is a constant built on the host once per geometry. The
relative-position table is read with ``index_select``, whose backward
(``index_add_``) is deterministic on the card in deterministic mode.
Patch merging edge-pads an odd map first. LayerNorms: flax
``nn.LayerNorm`` at eps 1e-5 (``ops/layernorm.LayerNorm``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm import LayerNorm
from ..ops.nn import Conv, Dense, replication_pad_to
from .upernet import SWIN_SPECS


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws * ws, C), windows in row order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // ws) * (w // ws), ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    c = x.shape[-1]
    x = x.reshape(-1, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


@functools.lru_cache(maxsize=None)
def _relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) int index into the (2ws-1)^2 relative-position table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, N, N) additive mask of shifted-window attention: 0
    within a region of the rolled map, -100 across regions."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask == 0, 0.0, -100.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_constant(kind: str, args: tuple, device: torch.device) -> torch.Tensor:
    """The index or mask of ``args`` on ``device``, copied there once."""
    if kind == "index":
        return torch.from_numpy(_relative_position_index(*args).reshape(-1)).to(device)
    return torch.from_numpy(_shift_mask(*args)).to(device)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.relative_position_bias = nn.Parameter(
            0.02 * torch.randn(((2 * window_size - 1) ** 2, num_heads), generator=generator))
        self.qkv = Dense(dim, 3 * dim, generator=generator)
        self.proj = Dense(dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        bnw, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = self.qkv(x, dtype).reshape(bnw, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (bnw, h, n, d)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
        idx = _device_constant("index", (self.window_size,), x.device)
        bias = self.relative_position_bias.index_select(0, idx).reshape(n, n, h)
        scores = scores + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            scores = (scores.reshape(bnw // nw, nw, h, n, n) + mask[None, :, None])
            scores = scores.reshape(bnw, h, n, n)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        out = torch.matmul(probs.float(), v.float()).to(dtype)
        return self.proj(out.transpose(1, 2).reshape(bnw, n, c), dtype)


class SwinBlock(nn.Module):
    """``map_side`` is the side of the map the block sees: its window
    min(window_size, map_side) sizes the relative-position table, as the
    flax parameter's shape follows the traced map."""

    def __init__(self, dim: int, num_heads: int, shift: int = 0, window_size: int = 7,
                 mlp_ratio: int = 4, map_side: int = 7,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.shift, self.window_size = shift, window_size
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, min(window_size, map_side),
                                    generator=generator)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.fc1 = Dense(dim, dim * mlp_ratio, generator=generator)
        self.fc2 = Dense(dim * mlp_ratio, dim, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = min(self.window_size, h, w)
        shift = self.shift if ws == self.window_size else 0
        y = self.norm1(x, dtype)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        if self.attn.window_size != ws or h % ws or w % ws:
            raise ValueError(f"a Swin block built for windows of {self.attn.window_size} "
                             f"got a {h}x{w} map (window {ws}): build the model at this "
                             "input size (image_size), a side whose stages the windows tile")
        mask = _device_constant("mask", (h, w, ws, shift), x.device) if shift else None
        y = window_reverse(self.attn(window_partition(y, ws), dtype, mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        y = self.fc1(self.norm2(x, dtype), dtype)
        return x + self.fc2(F.gelu(y), dtype)


class SwinTransformer(nn.Module):
    """A 4x4/s4 patch embedding and four stages (patch merging before
    stages 2-4); returns each stage's normed map. ``spec`` overrides
    (depths, embed, heads). ``image_size`` is the square input side the
    model is built for (the stages' windows follow it: 7 at every stage of
    a 224x224 input; 56x56 gives 7, 7, 4, 2)."""

    def __init__(self, in_channels: int, backbone: str = "swin_tiny", window_size: int = 7,
                 spec=None, image_size: int = 224, generator: torch.Generator | None = None):
        super().__init__()
        depths, embed, heads = spec or SWIN_SPECS[backbone]
        g = generator
        self.depths, self.window_size = tuple(depths), window_size
        self.patch_embed = Conv(in_channels, embed, 4, 4, padding="SAME", bias=True, generator=g)
        self.patch_norm = LayerNorm(embed, eps=1e-5)
        self.channels = []
        side = -(-image_size // 4)
        for s in range(4):
            dim = embed * 2**s
            if s > 0:
                side = -(-side // 2)
                self.add_module(f"merge_norm{s}", LayerNorm(2 * dim, eps=1e-5))
                self.add_module(f"merge{s}", Dense(2 * dim, dim, bias=False, generator=g))
            for b in range(depths[s]):
                self.add_module(f"stage{s}_block{b}", SwinBlock(
                    dim, heads[s], shift=0 if b % 2 == 0 else window_size // 2,
                    window_size=window_size, map_side=side, generator=g))
            self.add_module(f"out_norm{s}", LayerNorm(dim, eps=1e-5))
            self.channels.append(dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> list[torch.Tensor]:
        x = self.patch_norm(self.patch_embed(x, dtype), dtype)
        feats = []
        for s in range(4):
            if s > 0:
                b, h, w, c = x.shape
                if h % 2 or w % 2:
                    x = replication_pad_to(x, h + h % 2, w + w % 2)
                    h, w = h + h % 2, w + w % 2
                x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
                x = x.reshape(b, h // 2, w // 2, 4 * c)
                x = getattr(self, f"merge{s}")(getattr(self, f"merge_norm{s}")(x, dtype), dtype)
            for b in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{b}")(x, dtype)
            feats.append(getattr(self, f"out_norm{s}")(x, dtype))
        return feats
