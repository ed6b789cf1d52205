"""TransUNet-CD: a convolutional bottleneck encoder, a ViT over its 1/16
grid and a convolutional decoder, the two frames' features concatenated at
every level; counterpart of ``kurosiwo_tpu/models/transunet_cd.py``.

* Encoder: a 7x7 stride-2 conv, three bottleneck stages (each 1/2, no
  narrowing), a post-norm ViT over the 1/16 grid (a learned cls token,
  normal(1.0), and a position table, uniform(1.0), of (num_tokens + 1, dim)
  sliced to the tokens), a 3x3 conv to 512 channels.
* The attention scores are MULTIPLIED by sqrt(head_dim), the reference's
  quirk, and the fused qkv projection's feature axis is ordered (d, k, h)
  (``_split_ref_layout``). At the shipped width (1024 / 4 heads = 256) the
  head dimension takes the einsum route, in both packages.
* Decoder: four stages of a 2x bilinear upsample (align_corners=True), the
  skip concatenated before it, and two ConvBNAct; a 1x1 head.
* ``siamese``: one encoder for both frames (``encoder``), or one each
  (``encoder1``, ``encoder2``).

The position table's size is fixed when the model is built: num_tokens =
(img_dim / patch_dim) ** 2, with ``img_dim`` the side of the patches the
model will see (the factory passes the one the JAX engine initialises at).
Module names are the flax ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_packed
from ..ops.layernorm import LayerNorm
from ..ops.nn import Conv, ConvBNAct, Dense, resize_bilinear


def _split_ref_layout(qkv: torch.Tensor, heads: int):
    """q, k, v as packed (B, T, H*D) tensors from a projection whose feature
    axis is ordered (d, k, h), as the reference rearranges it."""
    b, t, dkh = qkv.shape
    d = dkh // (3 * heads)
    x = qkv.reshape(b, t, d, 3, heads)
    return tuple(x[:, :, :, i].transpose(2, 3).reshape(b, t, heads * d) for i in range(3))


class PostNormBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.heads, self.scale = heads, float(dim // heads) ** 0.5
        self.qkv = Dense(dim, 3 * dim, bias=False, generator=g)
        self.out_attention = Dense(dim, dim, bias=False, generator=g)
        self.norm1 = LayerNorm(dim)
        self.fc1 = Dense(dim, mlp_dim, generator=g)
        self.fc2 = Dense(mlp_dim, dim, generator=g)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        q, k, v = _split_ref_layout(self.qkv(x, dtype), self.heads)
        att = self.out_attention(attention_packed(q, k, v, self.heads, scale=self.scale), dtype)
        x = self.norm1(x + att, dtype)
        y = self.fc2(F.gelu(self.fc1(x, dtype), approximate="none"), dtype)
        return self.norm2(x + y, dtype)


class BottleneckViT(nn.Module):
    """ViT over the 1/16 feature grid (patch_dim 1, no classification)."""

    def __init__(self, cin: int, embedding_dim: int, heads: int, mlp_dim: int, blocks: int,
                 num_tokens: int, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.blocks = blocks
        self.projection = Dense(cin, embedding_dim, generator=g)
        self.cls_token = nn.Parameter(torch.randn((1, 1, embedding_dim), generator=g))
        self.embedding = nn.Parameter(torch.rand((num_tokens + 1, embedding_dim), generator=g))
        for i in range(blocks):
            self.add_module(f"block_{i}", PostNormBlock(embedding_dim, heads, mlp_dim,
                                                        generator=g))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, h, w, _ = x.shape
        tokens = self.projection(x.flatten(1, 2), dtype)
        cls = self.cls_token.to(tokens.dtype).expand(b, 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.embedding[None, :tokens.shape[1]].to(tokens.dtype)
        for i in range(self.blocks):
            tokens = getattr(self, f"block_{i}")(tokens, dtype)
        return tokens[:, 1:].reshape(b, h, w, -1)


class EncoderBottleneck(nn.Module):
    """The reference's bottleneck at width out_channels (no narrowing); its
    3x3 conv strides 2."""

    def __init__(self, cin: int, out_channels: int, stride: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        g, width = generator, out_channels
        self.downsample = ConvBNAct(cin, out_channels, 1, stride, act=False, padding=0,
                                    generator=g)
        self.conv1 = ConvBNAct(cin, width, 1, 1, padding=0, generator=g)
        self.conv2 = ConvBNAct(width, width, 3, 2, generator=g)
        self.conv3 = ConvBNAct(width, out_channels, 1, 1, act=False, padding=0, generator=g)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        down = self.downsample(x, dtype)
        y = self.conv3(self.conv2(self.conv1(x, dtype), dtype), dtype)
        return torch.relu(y + down)


class TransUNetEncoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, head_num: int, mlp_dim: int,
                 block_num: int, patch_dim: int, img_dim: int = 224,
                 generator: torch.Generator | None = None):
        super().__init__()
        g, oc = generator, out_channels
        self.conv1 = ConvBNAct(in_channels, oc, 7, 2, padding=3, generator=g)
        self.encoder1 = EncoderBottleneck(oc, oc * 2, generator=g)
        self.encoder2 = EncoderBottleneck(oc * 2, oc * 4, generator=g)
        self.encoder3 = EncoderBottleneck(oc * 4, oc * 8, generator=g)
        grid = img_dim // patch_dim
        self.vit = BottleneckViT(oc * 8, oc * 8, head_num, mlp_dim, block_num, grid * grid,
                                 generator=g)
        self.conv2 = ConvBNAct(oc * 8, 512, 3, 1, generator=g)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        x1 = self.conv1(x, dtype)
        x2 = self.encoder1(x1, dtype)
        x3 = self.encoder2(x2, dtype)
        x4 = self.conv2(self.vit(self.encoder3(x3, dtype), dtype), dtype)
        return x4, x1, x2, x3


class DecoderBottleneck(nn.Module):
    def __init__(self, cin: int, out_channels: int, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = ConvBNAct(cin, out_channels, 3, generator=generator)
        self.conv2 = ConvBNAct(out_channels, out_channels, 3, generator=generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None,
                dtype: torch.dtype) -> torch.Tensor:
        x = resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), align_corners=True)
        if skip is not None:
            x = torch.cat([skip, x], dim=-1)
        return self.conv2(self.conv1(x, dtype), dtype)


class TransUNetCD(nn.Module):
    """``forward(pre, post)``: two NHWC frames of side ``img_dim`` in,
    (B, H, W, num_classes) f32 logits out."""

    def __init__(self, in_channels: int, out_channels: int = 128, head_num: int = 4,
                 mlp_dim: int = 512, block_num: int = 8, patch_dim: int = 16,
                 num_classes: int = 3, siamese: bool = False, img_dim: int = 224,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.siamese = dtype, siamese
        g = generator
        kw = dict(out_channels=out_channels, head_num=head_num, mlp_dim=mlp_dim,
                  block_num=block_num, patch_dim=patch_dim, img_dim=img_dim, generator=g)
        if siamese:
            self.encoder = TransUNetEncoder(in_channels, **kw)
        else:
            self.encoder1 = TransUNetEncoder(in_channels, **kw)
            self.encoder2 = TransUNetEncoder(in_channels, **kw)
        oc = out_channels * 2
        # the bottom and the skips are the two frames' features concatenated:
        # 2 x 512, 2 x (4, 2, 1) x out_channels
        self.decoder1 = DecoderBottleneck(2 * 512 + 4 * oc, oc * 2, generator=g)
        self.decoder2 = DecoderBottleneck(oc * 2 + 2 * oc, oc, generator=g)
        self.decoder3 = DecoderBottleneck(oc + oc, oc // 2, generator=g)
        self.decoder4 = DecoderBottleneck(oc // 2, oc // 8, generator=g)
        self.head = Conv(oc // 8, num_classes, 1, bias=True, generator=g)

    def forward(self, pre: torch.Tensor, post: torch.Tensor, dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        enc1, enc2 = (self.encoder, self.encoder) if self.siamese else (self.encoder1,
                                                                       self.encoder2)
        x, x1, x2, x3 = (torch.cat([a, b], dim=-1) for a, b in zip(enc1(pre, dt), enc2(post, dt)))
        x = self.decoder1(x, x3, dt)
        x = self.decoder2(x, x2, dt)
        x = self.decoder3(x, x1, dt)
        x = self.decoder4(x, None, dt)
        return self.head(x, dt).float()
