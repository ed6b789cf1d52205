"""Unsupervised diffusion pretraining (task ``diffusion-unsup``); counterpart
of ``kurosiwo_tpu/models/diffusion.py`` (the reference's
``GaussianDiffusion(Unet(dim=64, dim_mults=(1, 2, 4, 8), channels=2),
timesteps=1000, loss_type="l1")``):

  * ``DDPMUnet``: the sinusoidal time embedding through a two-layer MLP
    (tanh-approximated GELU, flax's ``nn.gelu``); resnet blocks (GroupNorm,
    SiLU, a 3x3 conv, the time embedding's scale then shift after the second
    GroupNorm) over the ``dim_mults`` pyramid with 4x4/s2 downsamples; a
    linear-attention bottleneck; the skips concatenated on the way up, each
    level ending in a nearest 2x upsample and a 3x3 conv;
  * ``GaussianDiffusion``: linear betas, epsilon prediction, the L1 (or L2)
    loss at uniform timesteps, and the ancestral sampler.

Submodules carry the flax auto-names (``model.Dense_0``, ``model.Conv_0``,
``model.ResnetBlock_3.GroupNorm_1``, ``model.LinearAttention_0.Conv_1``),
so ``convert.flax_to_torch`` carries a flax tree across as it is.

flax's defaults, kept: every GroupNorm takes epsilon 1e-6 (the port's
``ops/nn.GroupNorm`` defaults to the ConvLSTM's 1e-5), every conv a bias
but the qkv projection (the port's ``ops/nn.Conv`` defaults to none). The
compute dtype is the model's (bf16 under ``mixed_precision``) on f32
parameters; the time embedding starts in f32, GroupNorm's statistics are
f32 and the loss is f32. ``LinearAttention`` is two einsums, as in JAX: it
goes through no attention kernel. No kernel of the port is launched here.

Random draws (the timesteps, the noise) come from the caller's
``torch.Generator``, unless the caller passes them in (the tests pass
``jax.random``'s).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import Conv, Dense, GroupNorm, upsample2x
from ..parallel.mesh import draw_rows

# flax nn.GroupNorm's epsilon
GN_EPS = 1e-6


def sinusoidal_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) f32 [sin, cos] features; frequencies
    exp(-log(10000) * i / (half - 1))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                      device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ResnetBlock(nn.Module):
    """GroupNorm -> SiLU -> 3x3 conv; the time embedding's Dense (scale,
    shift) applied after the second GroupNorm as h * (1 + scale) + shift;
    SiLU -> 3x3 conv; a 1x1 conv on the shortcut when the widths differ."""

    def __init__(self, cin: int, features: int, temb_dim: int, groups: int = 8,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(cin, groups, eps=GN_EPS)
        self.Conv_0 = Conv(cin, features, 3, padding=1, bias=True, generator=generator)
        self.Dense_0 = Dense(temb_dim, 2 * features, generator=generator)
        self.GroupNorm_1 = GroupNorm(features, groups, eps=GN_EPS)
        self.Conv_1 = Conv(features, features, 3, padding=1, bias=True, generator=generator)
        self.Conv_2 = (Conv(cin, features, 1, bias=True, generator=generator)
                       if cin != features else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = self.Conv_0(F.silu(self.GroupNorm_0(x, dtype)), dtype)
        scale, shift = self.Dense_0(F.silu(temb), dtype)[:, None, None, :].chunk(2, dim=-1)
        h = self.GroupNorm_1(h, dtype) * (1 + scale) + shift
        h = self.Conv_1(F.silu(h), dtype)
        if self.Conv_2 is not None:
            x = self.Conv_2(x, dtype)
        return x + h


class LinearAttention(nn.Module):
    """Linear attention: a bias-free 1x1 qkv; q softmaxed over the head
    dimension and scaled by dim_head ** -0.5, k over the positions; context
    k^T v, then q context, a 1x1 out conv and the residual."""

    def __init__(self, channels: int, heads: int = 4, dim_head: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.Conv_0 = Conv(channels, 3 * inner, 1, generator=generator)
        self.Conv_1 = Conv(inner, channels, 1, bias=True, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, h, w, _ = x.shape
        inner = self.heads * self.dim_head
        qkv = self.Conv_0(x, dtype).reshape(b, h * w, 3 * inner)
        q, k, v = (t.reshape(b, h * w, self.heads, self.dim_head).transpose(1, 2)
                   for t in qkv.split(inner, dim=-1))
        q = torch.softmax(q, dim=-1) * self.dim_head ** -0.5
        k = torch.softmax(k, dim=-2)
        ctx = torch.einsum("bhnd,bhne->bhde", k, v)
        out = torch.einsum("bhnd,bhde->bhne", q, ctx)
        out = out.transpose(1, 2).reshape(b, h, w, inner)
        return x + self.Conv_1(out, dtype)


class DDPMUnet(nn.Module):
    """The noise-prediction UNet on NHWC inputs of ``channels``: (x, t) ->
    (B, H, W, channels) in the compute dtype. H and W must halve
    ``len(dim_mults) - 1`` times."""

    def __init__(self, dim: int = 64, dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 2,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.dim, self.dtype = dim, dtype
        dims = [dim * m for m in dim_mults]
        temb = 4 * dim
        self.Dense_0 = Dense(dim, temb, generator=g)
        self.Dense_1 = Dense(temb, temb, generator=g)
        self.Conv_0 = Conv(channels, dim, 7, padding=3, bias=True, generator=g)
        blocks, convs = [], []  # in flax's creation order, for its names

        def block(cin: int, features: int) -> str:
            blocks.append(ResnetBlock(cin, features, temb, generator=g))
            return f"ResnetBlock_{len(blocks) - 1}"

        def conv(cin: int, features: int, kernel: int, **kw) -> str:
            convs.append(Conv(cin, features, kernel, bias=True, generator=g, **kw))
            return f"Conv_{len(convs)}"

        # (block, block, downsample conv or None) a level; the skips' widths
        self._down, skips, ch = [], [dim], dim
        for i, d in enumerate(dims):
            names = (block(ch, d), block(d, d))
            ch = d
            skips.append(ch)
            down = conv(d, d, 4, stride=2, padding=1) if i < len(dims) - 1 else None
            self._down.append((*names, down))
        self._mid = (block(ch, ch), block(ch, ch))
        self.LinearAttention_0 = LinearAttention(ch, generator=g)
        self._up = []
        for i, d in reversed(list(enumerate(dims))):
            names = (block(ch + skips.pop(), d), block(d, d))
            ch, up = d, None
            if i > 0:
                up, ch = conv(d, dims[i - 1], 3, padding=1), dims[i - 1]
            self._up.append((*names, up))
        self._final = block(ch + skips.pop(), dim)
        self._out = conv(dim, channels, 1)
        for k, m in enumerate(blocks):
            setattr(self, f"ResnetBlock_{k}", m)
        for k, m in enumerate(convs, start=1):
            setattr(self, f"Conv_{k}", m)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        temb = self.Dense_0(sinusoidal_time_embedding(t, self.dim), dt)
        temb = self.Dense_1(F.gelu(temb, approximate="tanh"), dt)
        h = self.Conv_0(x, dt)
        skips = [h]
        for a, b, down in self._down:
            h = getattr(self, b)(getattr(self, a)(h, temb, dt), temb, dt)
            skips.append(h)
            if down is not None:
                h = getattr(self, down)(h, dt)
        h = getattr(self, self._mid[0])(h, temb, dt)
        h = self.LinearAttention_0(h, dt)
        h = getattr(self, self._mid[1])(h, temb, dt)
        for a, b, up in self._up:
            h = torch.cat([h, skips.pop()], dim=-1)
            h = getattr(self, b)(getattr(self, a)(h, temb, dt), temb, dt)
            if up is not None:
                h = getattr(self, up)(upsample2x(h), dt)
        h = torch.cat([h, skips.pop()], dim=-1)
        h = getattr(self, self._final)(h, temb, dt)
        return getattr(self, self._out)(h, dt)


def linear_schedule(timesteps: int, beta_start: float = 1e-4,
                    beta_end: float = 0.02) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(betas, alphas, cumprod of alphas), f32, with ``jnp.linspace``'s
    arithmetic: start * (1 - s) + end * s at s = i / (T - 1), the last
    value ``beta_end``."""
    f32 = np.float32
    step = np.arange(timesteps - 1, dtype=f32) / f32(timesteps - 1)
    betas = np.concatenate([f32(beta_start) * (f32(1) - step) + f32(beta_end) * step,
                            [f32(beta_end)]]).astype(f32)
    alphas = (f32(1) - betas).astype(f32)
    return betas, alphas, np.cumprod(alphas, dtype=f32)


class GaussianDiffusion(nn.Module):
    """The DDPM around ``model`` (its parameters under ``model.``): the
    training loss (``forward``) and the ancestral sampler (``sample``). The
    schedule is held in f32 buffers that the ``state_dict`` leaves out."""

    def __init__(self, model: DDPMUnet, timesteps: int = 1000, loss_type: str = "l1",
                 beta_start: float = 1e-4, beta_end: float = 0.02):
        super().__init__()
        if loss_type not in ("l1", "l2"):
            raise ValueError(f"loss_type {loss_type!r}: l1 or l2")
        self.model, self.timesteps, self.loss_type = model, int(timesteps), loss_type
        betas, alphas, acp = (torch.from_numpy(a) for a in
                              linear_schedule(self.timesteps, beta_start, beta_end))
        self.register_buffer("betas", betas, persistent=False)
        self.register_buffer("alphas", alphas, persistent=False)
        self.register_buffer("acp", acp, persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    def forward(self, x0: torch.Tensor, t: torch.Tensor | None = None,
                noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """The f32 mean L1 (or L2) of the epsilon prediction's error at
        timesteps ``t`` (uniform in [0, T) from ``generator`` when None)
        with Gaussian ``noise`` (from ``generator`` when None)."""
        b = x0.shape[0]
        # under data parallelism: the global batch's draws, this rank's rows
        if t is None:
            t = draw_rows(lambda n: torch.randint(0, self.timesteps, (n,), generator=generator,
                                                  device=x0.device), b)
        if noise is None:
            noise = draw_rows(lambda n: torch.randn((n, *x0.shape[1:]), generator=generator,
                                                    device=x0.device, dtype=x0.dtype), b)
        t = t.to(x0.device)
        noise = noise.to(x0.device, x0.dtype)
        sqrt_acp = torch.sqrt(self.acp)[t].view(b, 1, 1, 1)
        sqrt_om = torch.sqrt(1.0 - self.acp)[t].view(b, 1, 1, 1)
        xt = sqrt_acp * x0 + sqrt_om * noise
        err = self.model(xt, t).float() - noise.float()
        return err.abs().mean() if self.loss_type == "l1" else err.square().mean()

    @torch.inference_mode()
    def sample(self, shape: tuple, generator: torch.Generator | None = None,
               noises: torch.Tensor | None = None) -> torch.Tensor:
        """The ancestral chain from t = T - 1 down to 0 on the model's
        device: x_T ~ N(0, I), then x_{t-1} = (x_t - beta_t / sqrt(1 -
        acp_t) eps) / sqrt(alpha_t) + sqrt(beta_t) z, with no noise added at
        t = 0. ``noises`` (T + 1, *shape) replaces the draws: [0] is x_T and
        [i + 1] the noise of step i (t = T - 1 - i)."""
        dev = self.betas.device
        draw = ((lambda i: noises[i].to(dev, torch.float32)) if noises is not None else
                (lambda i: torch.randn(shape, generator=generator, device=dev)))
        x = draw(0)
        for i in range(self.timesteps):
            t = self.timesteps - 1 - i
            eps = self.model(x, torch.full((shape[0],), t, device=dev, dtype=torch.long)).float()
            coef = self.betas[t] / torch.sqrt(1.0 - self.acp[t])
            x = (x - coef * eps) / torch.sqrt(self.alphas[t])
            if t > 0:
                x = x + torch.sqrt(self.betas[t]) * draw(i + 1)
        return x
