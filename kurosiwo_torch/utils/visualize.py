"""Qualitative visualization: reverse-scaled SAR images with mask overlays;
the port's copy of ``kurosiwo_tpu/utils/visualize.py`` (the reference's
wandb.Image block, ``training/segmentation_trainer.py:516-587``). One eval
sample is reverse-scaled (``data/normalize.reverse_scale_img``), gamma-0.3
enhanced (kornia's ``adjust_gamma``) and drawn with the ground-truth and
prediction class overlays. The rendering is numpy, so its images are the
JAX package's bit for bit; the wandb wrapper is optional.
"""

from __future__ import annotations

import numpy as np

from ..data.normalize import reverse_scale_img

# overlay colours: no-water (left transparent), permanent water blue,
# flood red, invalid black
CLASS_COLORS = {
    0: (64, 64, 64),
    1: (30, 110, 225),
    2: (220, 40, 40),
    3: (0, 0, 0),
}


def adjust_gamma(img: np.ndarray, gamma: float = 0.3) -> np.ndarray:
    """kornia.enhance.adjust_gamma's numerics: clip to [0, 1], power."""
    return np.clip(img, 0.0, 1.0) ** gamma


def sar_to_rgb(image: np.ndarray, scale_vars=None, config: dict | None = None,
               gamma: float = 0.3) -> np.ndarray:
    """(H, W, C >= 1) SAR image -> uint8 RGB for display: reverse-scaled
    when ``scale_vars`` and ``config`` are given, min-max normalized,
    gamma-enhanced; VV as grey (or the first three channels as RGB)."""
    img = np.asarray(image, np.float32)
    if scale_vars is not None and config is not None:
        img = reverse_scale_img(img, scale_vars[0], scale_vars[1], config)
    lo, hi = np.nanmin(img), np.nanmax(img)
    img = (img - lo) / max(hi - lo, 1e-12)
    img = adjust_gamma(img, gamma)
    rgb = img[..., :3] if img.shape[-1] >= 3 else np.repeat(img[..., :1], 3, axis=-1)
    return (rgb * 255).astype(np.uint8)


def overlay_mask(rgb: np.ndarray, mask: np.ndarray, alpha: float = 0.45) -> np.ndarray:
    """Blend the class colours onto an RGB image; class 0 stays as it is."""
    out = rgb.astype(np.float32)
    for cls, color in CLASS_COLORS.items():
        if cls == 0:
            continue
        sel = mask == cls
        out[sel] = (1 - alpha) * out[sel] + alpha * np.asarray(color, np.float32)
    return out.astype(np.uint8)


def prediction_triptych(image: np.ndarray, prediction: np.ndarray, mask: np.ndarray,
                        scale_vars=None, config: dict | None = None) -> dict[str, np.ndarray]:
    """The reference's logged triple, uint8 RGB each: the image, the image
    with the ground truth, the image with the prediction."""
    base = sar_to_rgb(image, scale_vars, config)
    return {
        "image": base,
        "ground_truth": overlay_mask(base, np.asarray(mask)),
        "prediction": overlay_mask(base, np.asarray(prediction)),
    }


def to_wandb_images(triptych: dict[str, np.ndarray]):
    """wandb.Image wrappers of a triptych, or None without wandb."""
    try:
        import wandb
    except ImportError:
        return None
    return {name: wandb.Image(img, caption=name) for name, img in triptych.items()}
