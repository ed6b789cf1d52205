"""FloodViT encoder (pre-norm ViT, learned positions and cls token);
counterpart of ``kurosiwo_tpu/models/vit.py``.

Submodules carry the flax names (``patch_norm1``, ``patch_proj``,
``transformer.attn_3.to_qkv``, ``transformer.ff_0.fc1``, ...), so a flax
tree maps onto the ``state_dict`` by path (``kurosiwo_torch/convert.py``).

Dtype policy (as ``ops/nn.py``): f32 parameters, each product casts its
input and parameters to the compute dtype, LayerNorms compute in f32 and
round once to it; no autocast. ``model(x, dtype=...)`` overrides the compute
dtype per call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_qkv
from ..ops.layernorm import LayerNorm
from ..ops.nn import Dense


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fc1 = Dense(dim, hidden_dim, generator=generator)
        self.fc2 = Dense(hidden_dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.fc1(self.norm(x, dtype), dtype)
        return self.fc2(F.gelu(x, approximate="none"), dtype)


class SelfAttention(nn.Module):
    """LayerNorm, fused qkv projection (no bias), packed attention, output
    projection. ``ring_axis`` (context parallelism) is not ported."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 ring_axis: str | None = None, generator: torch.Generator | None = None):
        super().__init__()
        if ring_axis is not None:
            raise NotImplementedError(
                "ring attention (ring_axis) is not ported yet (ROADMAP.md, A12)")
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.norm = LayerNorm(dim)
        self.to_qkv = Dense(dim, inner * 3, bias=False, generator=generator)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = Dense(inner, dim, generator=generator) if project_out else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        qkv = self.to_qkv(self.norm(x, dtype), dtype)
        # q, k, v are its column-thirds, read in place (and on the short route
        # the backward writes their gradients into the thirds of one tensor)
        out = attention_qkv(qkv, self.heads, scale=self.dim_head**-0.5)
        return self.to_out(out, dtype) if self.to_out is not None else out


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_{i}", SelfAttention(dim, heads, dim_head, generator=generator))
            self.add_module(f"ff_{i}", FeedForward(dim, mlp_dim, generator=generator))
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x, dtype) + x
            x = getattr(self, f"ff_{i}")(x, dtype) + x
        return self.norm(x, dtype)


def patchify(img: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC image -> (B, N, p*p*C) patches in the element order (p1, p2, c)."""
    b, hh, ww, c = img.shape
    h, w = hh // patch, ww // patch
    x = img.reshape(b, h, patch, w, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, patch * patch * c)


def unpatchify(patches: torch.Tensor, patch: int, h: int, w: int, c: int) -> torch.Tensor:
    b = patches.shape[0]
    x = patches.reshape(b, h // patch, w // patch, patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class ViT(nn.Module):
    def __init__(self, image_size: int = 224, patch_size: int = 16, num_classes: int = 1000,
                 dim: int = 1024, depth: int = 24, heads: int = 16, mlp_dim: int = 2048,
                 pool: str = "cls", channels: int = 6, dim_head: int = 64,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.patch_size, self.dim, self.pool, self.dtype = patch_size, dim, pool, dtype
        self.num_patches = (image_size // patch_size) ** 2
        patch_dim = patch_size * patch_size * channels
        self.patch_norm1 = LayerNorm(patch_dim)
        self.patch_proj = Dense(patch_dim, dim, generator=generator)
        self.patch_norm2 = LayerNorm(dim)
        self.pos_embedding = nn.Parameter(
            torch.randn((1, self.num_patches + 1, dim), generator=generator))
        self.cls_token = nn.Parameter(torch.randn((1, 1, dim), generator=generator))
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, generator=generator)
        # flax creates the head only where it is called: pool="cls" never does
        self.mlp_head = Dense(dim, num_classes, generator=generator) if pool == "mean" else None

    def embed_patches(self, patches: torch.Tensor,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
        """Patch pixels -> tokens (LN -> Linear -> LN), no positions."""
        dt = dtype or self.dtype
        return self.patch_norm2(self.patch_proj(self.patch_norm1(patches, dt), dt), dt)

    def embed_image(self, img: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Tokens straight from the NHWC image, the same math as
        ``embed_patches(patchify(img, p))`` (JAX ``vit.py:138-181``): the
        first LayerNorm's statistics over the strided (B, h, p, w, p, C) view,
        its scale folded into a stride-p VALID convolution kernel and its
        bias into a constant offset."""
        dt = dtype or self.dtype
        p = self.patch_size
        b, hh, ww, c = img.shape
        h, w = hh // p, ww // p
        norm = self.patch_norm1
        xf = img.float().reshape(b, h, p, w, p, c)
        mu = xf.mean(dim=(2, 4, 5), keepdim=True)
        m2 = xf.square().mean(dim=(2, 4, 5), keepdim=True)
        rstd = torch.rsqrt(m2 - mu.square() + norm.eps)
        xn = ((xf - mu) * rstd).to(dt).reshape(b, hh, ww, c)
        weight = self.patch_proj.weight  # (dim, p*p*C), columns in (p1, p2, c) order
        kf = (weight * norm.scale).reshape(self.dim, p, p, c).permute(0, 3, 1, 2)  # OIHW
        offset = weight @ norm.bias + self.patch_proj.bias
        y = F.conv2d(xn.permute(0, 3, 1, 2), kf.to(dt), stride=p)  # (B, dim, h, w)
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, self.dim) + offset.to(dt)
        return self.patch_norm2(y, dt)

    def forward(self, img: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        x = self.embed_image(img, dt)
        b, n, _ = x.shape
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding[:, : n + 1].to(x.dtype)
        x = self.transformer(x, dt)
        if self.pool == "mean":
            return self.mlp_head(x.mean(dim=1), dt)
        return x[:, 1:]  # pool="cls": all patch tokens, no head (the reference's quirk)
