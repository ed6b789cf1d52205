"""Phase-space (space-to-depth) layout, the part of
``kurosiwo_tpu/ops/phase.py`` the port needs.

Phase layout convention: a phase-space tensor Z of shape (B, H, W, 4*C)
corresponds to the full-resolution X = depth_to_space(Z) of shape
(B, 2H, 2W, C) with X[2i+a, 2j+b, c] = Z[i, j, (2a+b)*C + c].
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, 2H, 2W, C) -> (B, H, W, 4C), phase-major channel layout."""
    b, h2, w2, c = x.shape
    h, w = h2 // 2, w2 // 2
    return x.reshape(b, h, 2, w, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, 4 * c)


def space_to_depth_mask(m: torch.Tensor) -> torch.Tensor:
    """(B, 2H, 2W) mask -> (B, H, W, 4)."""
    b, h2, w2 = m.shape
    h, w = h2 // 2, w2 // 2
    return m.reshape(b, h, 2, w, 2).permute(0, 1, 3, 2, 4).reshape(b, h, w, 4)


def depth_to_space(z: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4C) -> (B, 2H, 2W, C)."""
    b, h, w, c4 = z.shape
    c = c4 // 4
    return z.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)
