"""MAE over the ViT encoder (FloodViT pretraining); counterpart of
``kurosiwo_tpu/models/mae.py``.

The JAX module draws its masking noise itself (``mae.py:62``); here the
caller passes the (B, N) uniform ``noise``, drawn by the train step from an
explicit ``torch.Generator`` (the tests hand in JAX's draw). The JAX package
selects and scatters tokens with one-hot matrix products, which suit the
TPU; here they are gathers and one scatter into a zero grid. Every slot
receives exactly one token, so the values are the same bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import Dense
from .vit import Transformer, ViT, patchify


class Embed(nn.Module):
    """flax ``nn.Embed`` table: ``embedding`` (num, features), initialised
    from a normal of variance 1/features as flax's default."""

    def __init__(self, num: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn((num, features), generator=generator) * features**-0.5)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b, k]] for (B, N, D) t and (B, K) idx."""
    return t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))


class MAE(nn.Module):
    def __init__(self, encoder: ViT, decoder_dim: int = 512, masking_ratio: float = 0.75,
                 decoder_depth: int = 8, decoder_heads: int = 16, decoder_dim_head: int = 64,
                 channels: int = 6, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = encoder
        self.decoder_dim, self.masking_ratio, self.dtype = decoder_dim, masking_ratio, dtype
        num_patches = encoder.num_patches
        patch_dim = encoder.patch_size**2 * channels
        self.enc_to_dec = (Dense(encoder.dim, decoder_dim, generator=generator)
                           if encoder.dim != decoder_dim else None)
        self.decoder_pos_emb = Embed(num_patches, decoder_dim, generator=generator)
        self.mask_token = nn.Parameter(torch.randn((decoder_dim,), generator=generator))
        self.decoder = Transformer(decoder_dim, decoder_depth, decoder_heads, decoder_dim_head,
                                   decoder_dim * 4, generator=generator)
        self.to_pixels = Dense(decoder_dim, patch_dim, generator=generator)

    def forward(self, img: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Reconstruction loss (f32 scalar) of NHWC ``img`` with the patches
        of the lowest ``masking_ratio`` share of ``noise`` (B, N) masked."""
        enc, dt = self.encoder, self.dtype
        tokens = enc.embed_image(img)
        b, n, _ = tokens.shape
        m = int(self.masking_ratio * n)
        patches = patchify(img.to(tokens.dtype), enc.patch_size)
        if enc.pool == "cls":
            tokens = tokens + enc.pos_embedding[:, 1 : n + 1].to(tokens.dtype)
        else:
            tokens = tokens + enc.pos_embedding.to(tokens.dtype)

        order = torch.argsort(noise, dim=-1, stable=True)
        masked, unmasked = order[:, :m], order[:, m:]
        encoded = enc.transformer(_take(tokens, unmasked), enc.dtype)
        kept = self.enc_to_dec(encoded, dt) if self.enc_to_dec is not None else encoded

        pos_table = self.decoder_pos_emb.embedding.to(dt)
        kept = kept + F.embedding(unmasked, pos_table)
        mask_tokens = self.mask_token.to(dt).expand(b, m, self.decoder_dim) \
            + F.embedding(masked, pos_table)
        # token order[b, j] goes to grid slot order[b, j]: masked first, then kept
        grid = kept.new_zeros((b, n, self.decoder_dim)).scatter(
            1, order[..., None].expand(-1, -1, self.decoder_dim),
            torch.cat([mask_tokens, kept.to(mask_tokens.dtype)], dim=1))

        decoded = self.decoder(grid, dt)
        pred = self.to_pixels(_take(decoded, masked), dt)
        target = _take(patches, masked)
        return torch.mean((pred.float() - target.float()) ** 2)
