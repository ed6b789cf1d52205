"""BiT-CD, the Bitemporal Image Transformer for change detection (Chen et
al. 2021); counterpart of ``kurosiwo_tpu/models/bit_cd.py``.

A dilated ResNet-18 trunk (BiT's vendored torchvision quirk: stages 3 and 4
stride 1 and not dilated, ``models/resnet.py``), a nearest 2x upsample and
a 3x3 conv to a 32-channel map at 1/4 of the input. ``net_G`` picks the
head (``build_bit_cd``):

* ``base_resnet18`` (the shipped config): |f1 - f2|, a 4x bilinear
  upsample and the two-layer conv head; no attention.
* the ``base_transformer_pos_s4`` variants: each frame's map is summarised
  into ``token_len`` semantic tokens (a bias-free 1x1 conv, a softmax over
  the H*W pixels, the weighted sum of the features); the two frames' tokens
  plus a learned position embedding go through a shared transformer
  encoder, and each frame's pixels attend to its own tokens in a
  transformer decoder (cross attention, Nq = H*W against Nk = token_len),
  before the same difference and head.

The attention scale is dim ** -0.5 with dim = 32, the model width and not
dim_head, the reference's quirk. The decoder normalizes query and memory
with the same LayerNorm (PreNorm2). LayerNorms are flax's (eps 1e-6,
``ops/layernorm.py``). Self-attention takes ``attention_qkv``, the cross
attention ``attention_packed``: B4 (``ops/short_attention.py``) where its
rule takes the shape (dim_head 64), einsum attention where it does not
(dim_head 8, ``..._dedim8``). Module names are the flax ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_packed, attention_qkv
from ..ops.layernorm import LayerNorm
from ..ops.nn import Conv, ConvBNAct, Dense, resize_bilinear, upsample2x
from .resnet import ResNetEncoder

DIM = 32  # the width of BiT's feature map and tokens


class TwoLayerConvHead(nn.Module):
    def __init__(self, channels: int, out_channels: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(channels, channels, 3, generator=generator)
        self.Conv_0 = Conv(channels, out_channels, 3, padding=1, bias=True, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.Conv_0(self.ConvBNAct_0(x, dtype), dtype)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.heads, self.scale = heads, dim**-0.5
        inner = heads * dim_head
        self.to_qkv = Dense(dim, inner * 3, bias=False, generator=generator)
        self.to_out = Dense(inner, dim, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = attention_qkv(self.to_qkv(x, dtype), self.heads, scale=self.scale)
        return self.to_out(out, dtype)


class _CrossAttention(nn.Module):
    """Pixels (x) attending to tokens (m); ``softmax=False`` is the
    reference's raw, unnormalized attention (``decoder_softmax`` off)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, softmax: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.heads, self.softmax, self.scale = heads, softmax, dim**-0.5
        inner = heads * dim_head
        g = generator
        self.to_q = Dense(dim, inner, bias=False, generator=g)
        self.to_k = Dense(dim, inner, bias=False, generator=g)
        self.to_v = Dense(dim, inner, bias=False, generator=g)
        self.to_out = Dense(inner, dim, generator=g)

    def forward(self, x: torch.Tensor, m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        q, k, v = self.to_q(x, dtype), self.to_k(m, dtype), self.to_v(m, dtype)
        if self.softmax:
            out = attention_packed(q, k, v, self.heads, scale=self.scale)
        else:
            b, n, inner = q.shape
            split = lambda t: t.reshape(b, t.shape[1], self.heads, -1).transpose(1, 2)
            dots = torch.einsum("bhid,bhjd->bhij", split(q), split(k)) * self.scale
            out = torch.einsum("bhij,bhjd->bhid", dots, split(v))
            out = out.transpose(1, 2).reshape(b, n, inner)
        return self.to_out(out, dtype)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, generator: torch.Generator | None = None):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden, generator=generator)
        self.Dense_1 = Dense(hidden, dim, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x, dtype), approximate="none"), dtype)


class TokenTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"norm_attn_{i}", LayerNorm(dim))
            self.add_module(f"attn_{i}", _Attention(dim, heads, dim_head, generator=generator))
            self.add_module(f"norm_ff_{i}", LayerNorm(dim))
            self.add_module(f"ff_{i}", _FeedForward(dim, mlp_dim, generator=generator))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for i in range(self.depth):
            layer = lambda name: getattr(self, f"{name}_{i}")
            x = layer("attn")(layer("norm_attn")(x, dtype), dtype) + x
            x = layer("ff")(layer("norm_ff")(x, dtype), dtype) + x
        return x


class TokenDecoder(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 softmax: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"norm_attn_{i}", LayerNorm(dim))
            self.add_module(f"attn_{i}", _CrossAttention(dim, heads, dim_head, softmax,
                                                         generator=generator))
            self.add_module(f"norm_ff_{i}", LayerNorm(dim))
            self.add_module(f"ff_{i}", _FeedForward(dim, mlp_dim, generator=generator))

    def forward(self, x: torch.Tensor, m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for i in range(self.depth):
            layer = lambda name: getattr(self, f"{name}_{i}")
            ln = layer("norm_attn")  # PreNorm2: one LayerNorm for query and memory
            x = layer("attn")(ln(x, dtype), ln(m, dtype), dtype) + x
            x = layer("ff")(layer("norm_ff")(x, dtype), dtype) + x
        return x


class BiTBackbone(nn.Module):
    """Dilated ResNet trunk -> 2x nearest upsample -> 3x3 conv to 32
    channels (1/4 of the input). ``resnet_stages_num`` indexes the trunk's
    feature list [x, stem, layer1, ..., layer4]: 4 is layer3 (1/8), 5
    layer4 (1/8); every stage runs either way, as in the JAX model."""

    def __init__(self, in_channels: int, backbone: str = "resnet18",
                 resnet_stages_num: int = 5, generator: torch.Generator | None = None):
        super().__init__()
        self.stages = resnet_stages_num
        self.resnet = ResNetEncoder(in_channels, backbone, generator=generator,
                                    dilations=(False, True, True), clamp_basic_dilation=True)
        self.conv_pred = Conv(self.resnet.channels[resnet_stages_num], DIM, 3, padding=1,
                              bias=True, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.resnet(x, dtype)[self.stages]
        return self.conv_pred(upsample2x(y, "nearest"), dtype)


def _upsample4x(d: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(d, (d.shape[1] * 4, d.shape[2] * 4))


class BiTResNet(nn.Module):
    """``net_G="base_resnet18"``: the siamese difference, no transformer."""

    def __init__(self, in_channels: int, num_classes: int = 3, backbone: str = "resnet18",
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.backbone = BiTBackbone(in_channels, backbone, generator=generator)
        self.classifier = TwoLayerConvHead(DIM, num_classes, generator=generator)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        d = torch.abs(self.backbone(x1, dt) - self.backbone(x2, dt))
        return self.classifier(_upsample4x(d), dt).float()


class BiTTransformer(nn.Module):
    """The ``BASE_Transformer`` variants: ``token_len`` tokens a frame, a
    learned position embedding (an f32 parameter cast to the compute
    dtype), ``enc_depth`` encoder and ``dec_depth`` decoder layers of 8
    heads."""

    def __init__(self, in_channels: int, num_classes: int = 3, token_len: int = 4,
                 enc_depth: int = 1, dec_depth: int = 8, dim_head: int = 64,
                 decoder_dim_head: int = 64, resnet_stages_num: int = 4,
                 backbone: str = "resnet18", decoder_softmax: bool = True,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.backbone = BiTBackbone(in_channels, backbone, resnet_stages_num, generator=g)
        self.conv_a = Conv(DIM, token_len, 1, generator=g)
        self.pos_embedding = nn.Parameter(torch.randn((1, 2 * token_len, DIM), generator=g))
        self.transformer = TokenTransformer(DIM, enc_depth, 8, dim_head, 2 * DIM, generator=g)
        self.transformer_decoder = TokenDecoder(DIM, dec_depth, 8, decoder_dim_head, 2 * DIM,
                                                decoder_softmax, generator=g)
        self.classifier = TwoLayerConvHead(DIM, num_classes, generator=g)

    def _tokens(self, f: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        att = torch.softmax(self.conv_a(f, dtype).flatten(1, 2).transpose(1, 2), dim=-1)
        return torch.einsum("bln,bnc->blc", att, f.flatten(1, 2))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        f1, f2 = self.backbone(x1, dt), self.backbone(x2, dt)
        tokens = torch.cat([self._tokens(f1, dt), self._tokens(f2, dt)], dim=1)
        tokens = self.transformer(tokens + self.pos_embedding.to(dt), dt)
        t1, t2 = tokens.chunk(2, dim=1)

        def decode(f, t):
            b, h, w, c = f.shape
            return self.transformer_decoder(f.reshape(b, h * w, c), t, dt).reshape(b, h, w, c)

        d = torch.abs(decode(f1, t1) - decode(f2, t2))
        return self.classifier(_upsample4x(d), dt).float()


def build_bit_cd(model_config: dict, in_channels: int, num_classes: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> nn.Module:
    """``net_G`` -> the model (JAX ``build_bit_cd``, ``define_G`` parity)."""
    net_g = model_config.get("net_G", "base_resnet18")
    kw = dict(num_classes=num_classes, dtype=dtype, generator=generator)
    if net_g == "base_resnet18":
        return BiTResNet(in_channels, **kw)
    variants = {
        # the reference's BASE_Transformer defaults: enc_depth 1, dec_depth 1
        "base_transformer_pos_s4": dict(dec_depth=1),
        "base_transformer_pos_s4_dd8": dict(dec_depth=8),
        "base_transformer_pos_s4_dd8_dedim8": dict(dec_depth=8, decoder_dim_head=8),
    }
    if net_g not in variants:
        raise NotImplementedError(f"Generator model name [{net_g}] is not recognized")
    return BiTTransformer(in_channels, token_len=4, resnet_stages_num=4, enc_depth=1,
                          **variants[net_g], **kw)
