"""ChangeFormerV6, a SegFormer-style siamese change detector (Bandara and
Patel 2022); counterpart of ``kurosiwo_tpu/models/changeformer.py``.

Encoder (``Tenc_x2``, shared by both frames): four stages of an overlapping
patch embed (a 7x7 conv at every stage, stride 4 then 2, LayerNorm eps
1e-5), efficient attention (keys and values from the map reduced by an
``sr`` conv of ratio 8, 4, 2, 1 with its LayerNorm, eps 1e-5; k and v the
two column halves of one ``kv`` projection), a Mix-FFN (fc1, a depthwise
3x3 conv, exact GELU, fc2), drop-path rates rising linearly from 0 to 0.1
over the 13 blocks, block LayerNorms eps 1e-6; depths (3, 3, 4, 3), widths
(64, 128, 320, 512), heads (1, 2, 4, 8).

Decoder (``TDec_x2``): per stage, from the deepest, a linear embed of both
frames, ``ConvDiff`` on their concatenation plus the 2x upsampled sum of
the deeper stages, a prediction head (deep supervision); the four maps
upsampled to stage 1's size, a 1x1 fuse conv and BatchNorm, then the tail:
two torch-geometry transposed convs (k4, s2, p1), each with a residual
block, and a 3x3 conv to the classes. The model returns a list of 5 f32
heads; ``decoder_softmax`` puts each through a sigmoid (the reference's
quirk).

Memory keys, which leave the function as it is:

* ``remat_ffn``: the Mix-FFN runs in a remat region (``ops/remat.py``),
  which keeps only its input. "auto" turns it on in training when the
  hidden tensor has B * N * dim * 4 >= 51,000,000 elements (at b128 stages
  1 and 2); True and False force it.
* ``tail_chunks``: the tail runs over that many batch chunks, each in its
  own remat region, so only one chunk's 4x-resolution temporaries are
  live. 0 is auto: 8 chunks in training at b >= 64 with b % 8 == 0; any
  other count becomes the largest divisor of the batch not above it.

Attention takes ``attention_packed``: B4 at stages 2 and 4 (D 64, H*D a
multiple of 128), einsum attention at stages 1 (H*D 64) and 3 (D 80), as
the JAX package routes them. The DropPath masks come from the step's
``generator`` (``ops/nn.DropPath``). Module names are the flax ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_packed
from ..ops.batchnorm import BatchNorm
from ..ops.layernorm import LayerNorm
from ..ops.nn import Conv, Dense, DropPath, TorchConvTranspose, resize_bilinear
from ..ops.remat import remat

EMBED_DIMS = (64, 128, 320, 512)
DEPTHS = (3, 3, 4, 3)
HEADS = (1, 2, 4, 8)
SR_RATIOS = (8, 4, 2, 1)
MLP_RATIO = 4
DROP_PATH_RATE = 0.1
REMAT_FFN_ELEMENTS = 51_000_000  # "auto": the Mix-FFN hidden size that turns remat on


def _tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(1, 2)


def _map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return x.reshape(x.shape[0], h, w, x.shape[-1])


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, patch: int, stride: int, embed_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.proj = Conv(cin, embed_dim, patch, stride, patch // 2, bias=True,
                         generator=generator)
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        x = self.proj(x, dtype)
        h, w = x.shape[1:3]
        return self.norm(_tokens(x), dtype), h, w


class EfficientAttention(nn.Module):
    """Spatial-reduction attention: the keys and values come from the map
    reduced ``sr_ratio`` times by a strided conv (flax's SAME padding)."""

    def __init__(self, dim: int, heads: int, sr_ratio: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.heads, self.sr_ratio, self.scale = heads, sr_ratio, (dim // heads) ** -0.5
        self.q = Dense(dim, dim, generator=g)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, sr_ratio, bias=True, generator=g)
            self.norm = LayerNorm(dim, eps=1e-5)
        self.kv = Dense(dim, 2 * dim, generator=g)
        self.proj = Dense(dim, dim, generator=g)

    def forward(self, x: torch.Tensor, h: int, w: int, dtype: torch.dtype) -> torch.Tensor:
        q = self.q(x, dtype)
        xs = x
        if self.sr_ratio > 1:
            r = self.sr_ratio
            m = _map(x, h, w)
            ph, pw = -h % r, -w % r  # SAME: the padding flax adds, half before
            if ph or pw:
                m = F.pad(m, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            xs = self.norm(_tokens(self.sr(m, dtype)), dtype)
        k, v = self.kv(xs, dtype).chunk(2, dim=-1)  # column halves, views of one projection
        return self.proj(attention_packed(q, k, v, self.heads, scale=self.scale), dtype)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.fc1 = Dense(dim, hidden, generator=g)
        self.dwconv = Conv(hidden, hidden, 3, padding=1, bias=True, groups=hidden, generator=g)
        self.fc2 = Dense(hidden, dim, generator=g)

    def forward(self, x: torch.Tensor, h: int, w: int, dtype: torch.dtype) -> torch.Tensor:
        x = _tokens(self.dwconv(_map(self.fc1(x, dtype), h, w), dtype))
        return self.fc2(F.gelu(x, approximate="none"), dtype)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, drop_path: float,
                 remat_ffn: bool | str = "auto", generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.dim, self.remat_ffn = dim, remat_ffn
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientAttention(dim, heads, sr_ratio, generator=g)
        self.norm2 = LayerNorm(dim)
        self.mlp = MixFFN(dim, dim * MLP_RATIO, generator=g)
        self.drop_path = DropPath(drop_path)

    def uses_remat(self, x: torch.Tensor) -> bool:
        if isinstance(self.remat_ffn, bool):
            return self.remat_ffn
        hidden = x.shape[0] * x.shape[1] * self.dim * MLP_RATIO
        return self.training and hidden >= REMAT_FFN_ELEMENTS

    def forward(self, x: torch.Tensor, h: int, w: int, dtype: torch.dtype,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x, dtype), h, w, dtype), generator)
        y = self.norm2(x, dtype)
        ffn = lambda t: self.mlp(t, h, w, dtype)
        y = remat(ffn, y) if self.uses_remat(x) else ffn(y)
        return x + self.drop_path(y, generator)


class EncoderTransformerV3(nn.Module):
    def __init__(self, in_channels: int, remat_ffn: bool | str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        total = sum(DEPTHS)
        rates = [DROP_PATH_RATE * i / max(total - 1, 1) for i in range(total)]
        cin, cur = in_channels, 0
        for s, (dim, depth) in enumerate(zip(EMBED_DIMS, DEPTHS)):
            self.add_module(f"patch_embed{s + 1}", OverlapPatchEmbed(
                cin, 7, 4 if s == 0 else 2, dim, generator=generator))
            for i in range(depth):
                self.add_module(f"block{s + 1}_{i}", EncoderBlock(
                    dim, HEADS[s], SR_RATIOS[s], rates[cur + i], remat_ffn, generator=generator))
            self.add_module(f"norm{s + 1}", LayerNorm(dim))
            cin, cur = dim, cur + depth

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: torch.Generator | None = None) -> list[torch.Tensor]:
        outs = []
        for s, depth in enumerate(DEPTHS):
            tok, h, w = getattr(self, f"patch_embed{s + 1}")(x, dtype)
            for i in range(depth):
                tok = getattr(self, f"block{s + 1}_{i}")(tok, h, w, dtype, generator)
            x = _map(getattr(self, f"norm{s + 1}")(tok, dtype), h, w)
            outs.append(x)
        return outs


class ConvDiff(nn.Module):
    def __init__(self, cin: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, padding=1, bias=True, generator=generator)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, padding=1, bias=True, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.BatchNorm_0(torch.relu(self.Conv_0(x, dtype)), dtype)
        return torch.relu(self.Conv_1(x, dtype))


class MakePrediction(nn.Module):
    """The first conv projects to the classes; BatchNorm and the second conv
    run at that width (``changeformer.py:41-47``)."""

    def __init__(self, cin: int, out_channels: int, generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = Conv(cin, out_channels, 3, padding=1, bias=True, generator=generator)
        self.BatchNorm_0 = BatchNorm(out_channels)
        self.Conv_1 = Conv(out_channels, out_channels, 3, padding=1, bias=True,
                           generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.BatchNorm_0(torch.relu(self.Conv_0(x, dtype)), dtype)
        return self.Conv_1(x, dtype)


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, padding=1, bias=True, generator=generator)
        self.conv2 = Conv(channels, channels, 3, padding=1, bias=True, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return x + self.conv2(torch.relu(self.conv1(x, dtype)), dtype) * 0.1


def _tail_chunk_count(requested: int, batch: int) -> int:
    """The largest divisor of ``batch`` not above ``requested`` (at least 1)."""
    nc = max(1, min(requested, batch))
    while nc > 1 and batch % nc:
        nc -= 1
    return nc


class DecoderTransformerV3(nn.Module):
    def __init__(self, embedding_dim: int = 256, num_classes: int = 3,
                 decoder_softmax: bool = True, tail_chunks: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        g, ed = generator, embedding_dim
        self.decoder_softmax, self.tail_chunks = decoder_softmax, tail_chunks
        for s in (3, 2, 1, 0):
            self.add_module(f"linear_c{s + 1}", Dense(EMBED_DIMS[s], ed, generator=g))
            self.add_module(f"diff_c{s + 1}", ConvDiff(2 * ed, ed, generator=g))
            self.add_module(f"make_pred_c{s + 1}", MakePrediction(ed, num_classes, generator=g))
        self.linear_fuse = Conv(4 * ed, ed, 1, bias=True, generator=g)
        self.fuse_bn = BatchNorm(ed)
        self.convd2x = TorchConvTranspose(ed, ed, 4, 2, 1, generator=g)
        self.dense_2x = ResidualBlock(ed, generator=g)
        self.convd1x = TorchConvTranspose(ed, ed, 4, 2, 1, generator=g)
        self.dense_1x = ResidualBlock(ed, generator=g)
        self.change_probability = Conv(ed, num_classes, 3, padding=1, bias=True, generator=g)

    def _tail(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.dense_2x(self.convd2x(x, dtype), dtype)
        x = self.dense_1x(self.convd1x(x, dtype), dtype)
        return self.change_probability(x, dtype)

    def chunk_count(self, batch: int) -> int:
        nc = self.tail_chunks or (8 if self.training and batch >= 64 and batch % 8 == 0 else 1)
        return _tail_chunk_count(nc, batch)

    def forward(self, f1: list[torch.Tensor], f2: list[torch.Tensor],
                dtype: torch.dtype) -> list[torch.Tensor]:
        c1_size = tuple(f1[0].shape[1:3])
        outputs, ups, acc = [], [], None
        for s in (3, 2, 1, 0):
            lin = getattr(self, f"linear_c{s + 1}")
            d = getattr(self, f"diff_c{s + 1}")(
                torch.cat([lin(f1[s], dtype), lin(f2[s], dtype)], dim=-1), dtype)
            if acc is not None:
                d = d + resize_bilinear(acc, (acc.shape[1] * 2, acc.shape[2] * 2))
            acc = d
            outputs.append(getattr(self, f"make_pred_c{s + 1}")(d, dtype))
            ups.append(resize_bilinear(d, c1_size) if tuple(d.shape[1:3]) != c1_size else d)
        # ups holds stages 4..1: the reference's cat((_c4_up, _c3_up, _c2_up, _c1))
        fused = self.fuse_bn(self.linear_fuse(torch.cat(ups, dim=-1), dtype), dtype)
        nc = self.chunk_count(fused.shape[0])
        tail = lambda x: self._tail(x, dtype)
        if nc > 1:
            cp = torch.cat([remat(tail, c) for c in fused.chunk(nc)])
        else:
            cp = tail(fused)
        outputs.append(cp)
        outputs = [o.float() for o in outputs]
        if self.decoder_softmax:
            outputs = [torch.sigmoid(o) for o in outputs]
        return outputs


class ChangeFormerV6(nn.Module):
    """``forward(x1, x2)``: two NHWC frames in, a list of 5 f32 heads out,
    the last at the input's size; ``dtype`` overrides the compute dtype per
    call (the f32 twin); the DropPath masks come from ``generator``."""

    def __init__(self, in_channels: int, embed_dim: int = 256, num_classes: int = 3,
                 decoder_softmax: bool = True, tail_chunks: int = 0,
                 remat_ffn: bool | str = "auto", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.Tenc_x2 = EncoderTransformerV3(in_channels, remat_ffn, generator=generator)
        self.TDec_x2 = DecoderTransformerV3(embed_dim, num_classes, decoder_softmax, tail_chunks,
                                            generator=generator)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> list[torch.Tensor]:
        dt = dtype or self.dtype
        return self.TDec_x2(self.Tenc_x2(x1, dt, generator), self.Tenc_x2(x2, dt, generator), dt)
