"""FloodViT encoder (pre-norm ViT, learned positions and cls token);
counterpart of ``kurosiwo_tpu/models/vit.py``.

Submodules carry the flax names (``patch_norm1``, ``patch_proj``,
``transformer.attn_3.to_qkv``, ``transformer.ff_0.fc1``, ...), so a flax
tree maps onto the ``state_dict`` by path (``kurosiwo_torch/convert.py``).

Dtype policy (as ``ops/nn.py``): f32 parameters, each product casts its
input and parameters to the compute dtype, LayerNorms compute in f32 and
round once to it; no autocast. ``model(x, dtype=...)`` overrides the compute
dtype per call.

Context parallelism (JAX ``ring_axis``): ``SelfAttention`` and
``Transformer`` take the ring's process group (a ``MeshPlan``'s
``model_group``, or ``ops/ring_attention.SOLO``), at construction or per
call; the tokens they are given are then this rank's contiguous shard of
the sequence, and attention is a ring pass
(``ops/ring_attention.ring_attention_p``). Everything else in a block is
token-pointwise. The parameters and their names are unchanged, so converted
weights load as before.

Tensor parallelism (``parallel/sharding.py``, JAX's ``param_shardings``):
where JAX's rule cuts a block's leaves, ``SelfAttention`` keeps its heads
local, ``to_qkv`` cut by head (rank m holds q, k and v of heads
[m H/P, (m+1) H/P): the packed attention runs on H/P heads, B5 or B4 on the
shard) and ``to_out`` row-parallel on those heads' features, one sum over
the model group; ``FeedForward`` makes ``fc1`` column-parallel and ``fc2``
row-parallel. JAX cuts ``to_qkv`` as one block of columns and ``to_out``,
``fc2`` on their output features; the picked leaves and their gathered
values are the same (ROADMAP C26). ``pos_embedding`` is gathered before the
add. A model cut so takes no ring.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_qkv
from ..ops.layernorm import LayerNorm
from ..ops.nn import Dense
from ..ops.ring_attention import SOLO, ring_attention_p
from ..ops.short_attention import _heads_view
from ..parallel.mesh import full_param, gather_out, shard_of


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fc1 = Dense(dim, hidden_dim, generator=generator)
        self.fc2 = Dense(hidden_dim, dim, generator=generator)

    def tp_layouts(self, num_model: int) -> dict:
        """``fc2`` row-parallel (its input features), beside a cut ``fc1``."""
        hidden = self.fc1.weight.shape[0]
        return {"fc2.weight": (1, "block")} if hidden % num_model == 0 else {}

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # fc1's slice of the hidden features goes straight into fc2's rows
        paired = shard_of(self.fc1) is not None and _row_cut(self.fc2)
        x = self.fc1(self.norm(x, dtype), dtype, gather=not paired)
        return self.fc2(F.gelu(x, approximate="none"), dtype, local_in=paired)


def _row_cut(dense: Dense) -> bool:
    shard = shard_of(dense)
    return shard is not None and shard.dim == 1


class SelfAttention(nn.Module):
    """LayerNorm, fused qkv projection (no bias), packed attention, output
    projection. ``ring_axis``: the ring's process group (see the module
    docstring), or None for attention over the tokens given."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 ring_axis=None, generator: torch.Generator | None = None):
        super().__init__()
        if isinstance(ring_axis, str) and ring_axis != SOLO:
            raise TypeError(f"ring_axis takes the ring's process group (a MeshPlan's "
                            f"model_group), not the mesh axis name {ring_axis!r}")
        self.ring_axis = ring_axis
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.norm = LayerNorm(dim)
        self.to_qkv = Dense(dim, inner * 3, bias=False, generator=generator)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = Dense(inner, dim, generator=generator) if project_out else None

    def tp_layouts(self, num_model: int) -> dict:
        """``to_qkv`` cut by head and ``to_out`` on those heads' features,
        where the heads divide by the model axis."""
        if self.heads % num_model:
            return {}
        out = {"to_qkv.weight": (0, "thirds")}
        if self.to_out is not None:
            out["to_out.weight"] = (1, "block")
        return out

    def forward(self, x: torch.Tensor, dtype: torch.dtype, ring_axis=None) -> torch.Tensor:
        ring = ring_axis if ring_axis is not None else self.ring_axis
        shard = shard_of(self.to_qkv)
        if shard is not None and ring is not None:
            raise ValueError("a tensor-parallel SelfAttention takes no ring: both use the "
                             "model axis")
        # heads local where to_qkv is cut by head; a block cut (heads that do
        # not divide by the axis) joins the columns and runs every head
        local = shard is not None and shard.layout == "thirds"
        qkv = self.to_qkv(self.norm(x, dtype), dtype, gather=not local)
        # q, k, v are its column-thirds, read in place (and on the short route
        # the backward writes their gradients into the thirds of one tensor)
        if ring is None:
            heads = self.heads // shard.count if local else self.heads
            out = attention_qkv(qkv, heads, scale=self.dim_head**-0.5)
            if local:
                if self.to_out is not None and _row_cut(self.to_out):
                    return self.to_out(out, dtype, local_in=True)
                out = gather_out(out, dataclasses.replace(shard, layout="block"))
        else:
            q, k, v = (_heads_view(t, self.heads) for t in qkv.chunk(3, dim=-1))
            out = ring_attention_p(q, k, v, ring, scale=self.dim_head**-0.5)
            out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
        return self.to_out(out, dtype) if self.to_out is not None else out


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 generator: torch.Generator | None = None, ring_axis=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_{i}", SelfAttention(dim, heads, dim_head, ring_axis=ring_axis,
                                                       generator=generator))
            self.add_module(f"ff_{i}", FeedForward(dim, mlp_dim, generator=generator))
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, ring_axis=None) -> torch.Tensor:
        """``ring_axis``: the ring's group for this call (see the module
        docstring); None keeps the layers' own."""
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x, dtype, ring_axis) + x
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
    tp_aware = True  # pos_embedding and patch_proj's weight are taken whole

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
        # (dim, p*p*C), columns in (p1, p2, c) order
        weight = full_param(self.patch_proj, "weight")
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
        pos = full_param(self, "pos_embedding")
        x = torch.cat([cls, x], dim=1) + pos[:, : n + 1].to(x.dtype)
        x = self.transformer(x, dt)
        if self.pool == "mean":
            return self.mlp_head(x.mean(dim=1), dt)
        return x[:, 1:]  # pool="cls": all patch tokens, no head (the reference's quirk)
