"""LayerNorm of the ViT/MAE models; counterpart of
``kurosiwo_tpu/ops/fused_ln.py``.

The same function as ``flax.linen.LayerNorm(epsilon=1e-6)`` with the JAX
package's hand-derived backward: f32 statistics over the last axis with the
variance as E[x^2] - mean^2, one rounding of the result to the module's
compute dtype, and per-row f32 (mean, rstd) as the only residuals beside the
input. ``F.layer_norm`` is not this function: it computes the variance
another way and, for a bf16 input with f32 parameters, rounds elsewhere.

Plain PyTorch: no Pallas kernel stands behind it in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn


def _stats(x: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.square().mean(-1, keepdim=True) - mu.square()
    return xf, mu, torch.rsqrt(var + eps)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        xf, mu, rstd = _stats(x, eps)
        y = ((xf - mu) * rstd * scale + bias).to(out_dtype)
        ctx.save_for_backward(x, mu, rstd, scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mu, rstd, scale = ctx.saved_tensors
        dyf = dy.float()
        xhat = (x.float() - mu) * rstd
        dxhat = dyf * scale
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
        rows = tuple(range(dy.dim() - 1))
        dscale = (dyf * xhat).sum(rows)
        dbias = dyf.sum(rows)
        return dx, dscale, dbias, None, None


class LayerNorm(nn.Module):
    """flax-semantics LayerNorm over the last axis; parameters ``scale`` and
    ``bias`` carry the flax names. The output is in ``dtype``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _LayerNorm.apply(x, self.scale, self.bias, self.eps, dtype)
