"""Batched augmentations on the step's device; the port's own copy of
``kurosiwo_tpu/data/augment.py``, which the train step runs on the whole
batch before assembling the model input.

Each operation is split into a *draw* of its random values (crop boxes,
coins, sigmas, offsets, noise) from an explicit ``torch.Generator`` on the
step's device, and an *apply* that takes the draws. The JAX package draws
from ``jax.random`` keys, whose stream torch cannot reproduce; the applies
compute JAX's functions, so fed JAX's draws they give JAX's batches (the
CPU tests do so).

The same draws serve all three acquisitions (and the DEM) and both masks
(label and valid) of a sample:
  * RandomResizedCrop: a per-sample box, resampled as
    ``jax.image.scale_and_translate(..., "linear", antialias=False)`` does:
    per-sample (out, in) triangle-kernel weight matrices
    (``compute_weight_mat``), applied as two batched f32 products; masks
    take the nearest row and column of ``_nearest_selection``;
  * Horizontal/Vertical flip: a per-sample select of the reversed view;
  * GaussianBlur: separable, per-sample sigma, reflect-101 border;
  * GaussNoise, MultiplicativeNoise, Cutout (CoarseDropout);
  * ElasticTransform: a 3-point affine composed with a smoothed
    displacement field, sampled once (``map_coordinates`` order 1 for
    images and 0 for masks, mirror border, written out as a gather);
  * the reference's discard-if-empty rule (Dataset.py:797-803): a sample
    whose augmented valid mask is empty keeps its originals.

Configured operations outside this set raise when p > 0 (the reference's
factory silently repeats the previous transform for an unknown key).
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import draw_rows

_SUPPORTED_AUGMENTATIONS = {
    "RandomResizedCrop",
    "HorizontalFlip",
    "VerticalFlip",
    "GaussianBlur",
    "ElasticTransform",
    "Cutout",
    "GaussianNoise",  # the reference factory's key for A.GaussNoise
    "GaussNoise",
    "MultNoise",
}
IMAGE_KEYS = ("post", "pre1", "pre2", "dem")
MASK_KEYS = ("mask", "valid")


def check_augmentations(config: dict) -> None:
    """Raise on a configured operation that is not supported and has
    p > 0."""
    for name, spec in (config.get("augmentations") or {}).items():
        if name not in _SUPPORTED_AUGMENTATIONS and isinstance(spec, dict) and spec.get("p", 0) > 0:
            raise ValueError(
                f"augmentation {name!r} is configured with p={spec['p']} but is not "
                f"supported (supported: {sorted(_SUPPORTED_AUGMENTATIONS)})"
            )


def _uniform(g: torch.Generator, shape, lo=0.0, hi=1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=g, device=g.device)
    return u if (lo, hi) == (0.0, 1.0) else u * (hi - lo) + lo


def _coin(g: torch.Generator, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) < p


# -- RandomResizedCrop ----------------------------------------------------

def _sample_crop_boxes(g: torch.Generator, batch: int, h: int, w: int, scale,
                       ratio=(3 / 4, 4 / 3)):
    """Per-sample (y0, x0, ch, cw) in pixels, albumentations-style: area
    scale uniform, aspect log-uniform."""
    target_area = _uniform(g, (batch,), scale[0], scale[1]) * (h * w)
    aspect = torch.exp(_uniform(g, (batch,), math.log(ratio[0]), math.log(ratio[1])))
    cw = torch.clamp(torch.sqrt(target_area * aspect), 8.0, w)
    ch = torch.clamp(torch.sqrt(target_area / aspect), 8.0, h)
    y0 = _uniform(g, (batch,)) * (h - ch)
    x0 = _uniform(g, (batch,)) * (w - cw)
    return y0, x0, ch, cw


def draw_random_resized_crop(g: torch.Generator, batch: int, h: int, w: int, scale,
                             p: float = 1.0) -> dict:
    """The boxes; a sample whose coin skips the crop gets the whole image
    (a plain resize, the identity at out_size == H)."""
    y0, x0, ch, cw = _sample_crop_boxes(g, batch, h, w, scale)
    if p < 1.0:
        apply = _coin(g, p, (batch,))
        y0, x0 = torch.where(apply, y0, 0.0), torch.where(apply, x0, 0.0)
        ch, cw = torch.where(apply, ch, float(h)), torch.where(apply, cw, float(w))
    return {"y0": y0, "x0": x0, "ch": ch, "cw": cw}


def _linear_weights(in_size: int, out_size: int, start: torch.Tensor,
                    crop: torch.Tensor) -> torch.Tensor:
    """(B, in, out) weights of ``scale_and_translate``'s "linear" resample of
    [start, start + crop) to out_size, antialias off (``compute_weight_mat``
    with scale out/crop and translation -start * scale)."""
    scale = out_size / crop
    translation = -start * scale
    inv_scale = 1.0 / scale
    dev = crop.device
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)[None, :] + 0.5)
                * inv_scale[:, None] - (translation * inv_scale)[:, None] - 0.5)  # (B, out)
    x = torch.abs(sample_f[:, None, :]
                  - torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None])
    weights = torch.clamp_min(1.0 - x, 0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def _nearest_index(start: torch.Tensor, crop: torch.Tensor, in_dim: int,
                   out_dim: int) -> torch.Tensor:
    """(B, out) source index of each output row of ``_nearest_selection``."""
    u = ((torch.arange(out_dim, dtype=torch.float32, device=crop.device)[None, :] + 0.5)
         * (crop / out_dim)[:, None] + start[:, None])
    return torch.clamp(torch.floor(u), 0, in_dim - 1).long()


def random_resized_crop(images: list, masks: list, out_size: int, draws: dict):
    """Every image resampled (f32 weight products) and every mask taken
    nearest, over the drawn boxes; images (B, H, W, C), masks (B, H, W)."""
    b, h, w = images[0].shape[:3]
    y0, x0, ch, cw = draws["y0"], draws["x0"], draws["ch"], draws["cw"]
    wh = _linear_weights(h, out_size, y0, ch)  # (B, H, out)
    ww = _linear_weights(w, out_size, x0, cw)  # (B, W, out)
    out_images = []
    for img in images:
        x = torch.einsum("bhy,bhwc->bywc", wh, img.float())
        out_images.append(torch.einsum("bwx,bywc->byxc", ww, x).to(img.dtype))
    rows = _nearest_index(y0, ch, h, out_size)  # (B, out)
    cols = _nearest_index(x0, cw, w, out_size)
    out_masks = []
    for m in masks:
        picked = torch.gather(m, 1, rows[:, :, None].expand(b, out_size, w))
        out_masks.append(torch.gather(picked, 2, cols[:, None, :].expand(b, out_size, out_size)))
    return out_images, out_masks


# -- flips ----------------------------------------------------------------

def draw_flips(g: torch.Generator, batch: int, p_h: float, p_v: float) -> dict:
    return {"h": _coin(g, p_h, (batch,)), "v": _coin(g, p_v, (batch,))}


def flips(images: list, masks: list, draws: dict):
    do_h, do_v = draws["h"], draws["v"]
    images = [torch.where(do_h[:, None, None, None], img.flip(2), img) for img in images]
    images = [torch.where(do_v[:, None, None, None], img.flip(1), img) for img in images]
    masks = [torch.where(do_h[:, None, None], m.flip(2), m) for m in masks]
    masks = [torch.where(do_v[:, None, None], m.flip(1), m) for m in masks]
    return images, masks


# -- Gaussian blur ----------------------------------------------------------

def _reflect_index(n: int, radius: int, device) -> torch.Tensor:
    """Indices of a reflect-101 padding of ``radius`` on each side."""
    i = torch.arange(-radius, n + radius, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _blur2d(field: torch.Tensor, sigma: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable Gaussian blur over axes 1 and 2 with a per-sample sigma and
    a fixed (ksize, ksize) kernel, reflect-101 border (cv2.GaussianBlur)."""
    radius = ksize // 2
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32, device=field.device)
    kern = torch.exp(-0.5 * (offsets[None, :] / sigma[:, None]) ** 2)
    kern = kern / kern.sum(dim=1, keepdim=True)  # (B, K)

    def blur_axis(x, axis):
        n = x.shape[axis]
        padded = torch.index_select(x, axis, _reflect_index(n, radius, x.device))
        stack = torch.stack([padded.narrow(axis, i, n) for i in range(ksize)], dim=-1)
        wts = kern.reshape((x.shape[0],) + (1,) * (x.ndim - 1) + (ksize,))
        return (stack * wts).sum(dim=-1)

    return blur_axis(blur_axis(field, 1), 2)


def _blur_radius(sigma_limit) -> int:
    return max(1, int(math.ceil(3 * sigma_limit[1])))


def draw_gaussian_blur(g: torch.Generator, batch: int, p: float, sigma_limit=(0.1, 2.0)) -> dict:
    return {"sigma": _uniform(g, (batch,), sigma_limit[0], sigma_limit[1]),
            "apply": _coin(g, p, (batch,))}


def gaussian_blur(images: list, draws: dict, sigma_limit=(0.1, 2.0)) -> list:
    ksize = 2 * _blur_radius(sigma_limit) + 1
    apply = draws["apply"][:, None, None, None]
    return [torch.where(apply, _blur2d(img.float(), draws["sigma"], ksize).to(img.dtype), img)
            for img in images]


# -- noise --------------------------------------------------------------------

def draw_gauss_noise(g: torch.Generator, shapes: list, p: float,
                     var_limit=(10.0, 50.0)) -> list:
    """Per image (of the given (B, H, W, C) shapes): the coin, the variance
    and unit normal noise."""
    return [{"apply": _coin(g, p, shape[:1]), "var": _uniform(g, shape[:1], *var_limit),
             "noise": torch.randn(shape, generator=g, device=g.device)} for shape in shapes]


def gauss_noise(images: list, draws: list, scale: float = 1.0 / 255) -> list:
    out = []
    for img, d in zip(images, draws):
        noise = d["noise"] * torch.sqrt(d["var"])[:, None, None, None] * scale
        out.append(torch.where(d["apply"][:, None, None, None], img + noise.to(img.dtype), img))
    return out


def draw_multiplicative_noise(g: torch.Generator, images: list, p: float,
                              limits=(0.9, 1.1), batch: int | None = None) -> list:
    """One gain per image and sample (A.MultiplicativeNoise's defaults,
    elementwise=False, per_channel=False); ``batch`` samples (default the
    images')."""
    b = images[0].shape[0] if batch is None else batch
    return [{"apply": _coin(g, p, (b,)), "mult": _uniform(g, (b,), limits[0], limits[1])}
            for _ in images]


def multiplicative_noise(images: list, draws: list) -> list:
    return [torch.where(d["apply"][:, None, None, None],
                        img * d["mult"].to(img.dtype)[:, None, None, None], img)
            for img, d in zip(images, draws)]


# -- elastic transform ---------------------------------------------------------

def _affine_from_points(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3) affine M with M @ [x, y, 1] = (x', y') taking pts1 to pts2
    (cv2.getAffineTransform; JAX solves the 3x3 system). pts: (B, 3, 2) as
    (x, y). Cramer's rule in elementwise f32, so the card and the CPU give
    the same bits."""
    (x0, x1, x2), (y0, y1, y2) = pts1[..., 0].unbind(-1), pts1[..., 1].unbind(-1)
    det = x0 * (y1 - y2) - y0 * (x1 - x2) + (x1 * y2 - y1 * x2)
    rows = []
    for u0, u1, u2 in (pts2[..., 0].unbind(-1), pts2[..., 1].unbind(-1)):
        a = u0 * (y1 - y2) - y0 * (u1 - u2) + (u1 * y2 - y1 * u2)
        b = x0 * (u1 - u2) - u0 * (x1 - x2) + (x1 * u2 - u1 * x2)
        c = x0 * (y1 * u2 - u1 * y2) - y0 * (x1 * u2 - u1 * x2) + u0 * (x1 * y2 - y1 * x2)
        rows.append(torch.stack([a, b, c], dim=-1) / det[:, None])
    return torch.stack(rows, dim=1)


def _invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert a (B, 2, 3) affine (cv2.invertAffineTransform), elementwise."""
    a, b, c = m[:, 0].unbind(-1)
    d, e, f = m[:, 1].unbind(-1)
    det = a * e - b * d
    ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
    return torch.stack([torch.stack([ia, ib, -(ia * c + ib * f)], dim=-1),
                        torch.stack([id_, ie, -(id_ * c + ie * f)], dim=-1)], dim=1)


def _mirror(index: torch.Tensor, size: int) -> torch.Tensor:
    """``map_coordinates``' mirror border: the triangle wave of period
    2 (size - 1)."""
    s = size - 1
    return torch.abs(torch.remainder(index + s, 2 * s) - s)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x), 0.0)


def _sample_bilinear(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(order=1, mode="mirror")`` of each channel of
    (B, H, W, C) at (B, H', W') coordinates: the four corners' products
    summed in its order."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    y_lo, x_lo = torch.floor(sy), torch.floor(sx)
    wy_hi, wx_hi = sy - y_lo, sx - x_lo
    ys = [(_mirror(y_lo.long(), h), 1 - wy_hi), (_mirror(y_lo.long() + 1, h), wy_hi)]
    xs = [(_mirror(x_lo.long(), w), 1 - wx_hi), (_mirror(x_lo.long() + 1, w), wx_hi)]
    out = None
    for iy, wy in ys:
        for ix, wx in xs:
            idx = (iy * w + ix).reshape(b, -1, 1).expand(-1, -1, c)
            term = (wy * wx)[..., None] * torch.gather(flat, 1, idx).reshape(sy.shape + (c,))
            out = term if out is None else out + term
    return out


def _sample_nearest(m: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(order=0, mode="mirror")`` of (B, H, W) integer masks:
    coordinates rounded half away from zero."""
    b, h, w = m.shape
    iy = _mirror(_round_half_away(sy).long(), h)
    ix = _mirror(_round_half_away(sx).long(), w)
    return torch.gather(m.reshape(b, -1), 1, (iy * w + ix).reshape(b, -1)).reshape(sy.shape)


def draw_elastic_transform(g: torch.Generator, batch: int, h: int, w: int, p: float,
                           alpha_affine: float = 50.0, same_dxdy: bool = False) -> dict:
    """The coin, the affine's point offsets U(-alpha_affine, alpha_affine)
    and the raw U(-1, 1) displacement fields (blurred in the apply)."""
    d = {"apply": _coin(g, p, (batch,)),
         "offsets": _uniform(g, (batch, 3, 2), -alpha_affine, alpha_affine),
         "dx": _uniform(g, (batch, h, w), -1.0, 1.0)}
    d["dy"] = d["dx"] if same_dxdy else _uniform(g, (batch, h, w), -1.0, 1.0)
    return d


def elastic_transform(images: list, masks: list, draws: dict, alpha: float = 1.0,
                      sigma: float = 50.0, approximate: bool = True):
    """albumentations ElasticTransform (the reference's factory,
    utilities/augmentations.py:22-34): a random 3-point affine on a centred
    square composed with a Gaussian-smoothed displacement field scaled by
    alpha; the two warps are one sampling map, so each pixel is resampled
    once. Bilinear for images, nearest for masks, mirror border."""
    b, h, w = images[0].shape[:3]
    dev = images[0].device
    cy, cx, ss = h // 2, w // 2, min(h, w) // 3
    pts1 = torch.tensor([[cx + ss, cy + ss], [cx + ss, cy - ss], [cx - ss, cy - ss]],
                        dtype=torch.float32, device=dev)[None].expand(b, 3, 2)
    m_inv = _invert_affine(_affine_from_points(pts1, pts1 + draws["offsets"]))  # dst -> src
    ksize = 17 if approximate else 2 * int(4 * float(sigma) + 0.5) + 1
    sig = torch.full((b,), float(sigma), dtype=torch.float32, device=dev)
    dx = _blur2d(draws["dx"], sig, ksize) * alpha
    dy = dx if draws["dy"] is draws["dx"] else _blur2d(draws["dy"], sig, ksize) * alpha
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + dx
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + dy

    def row(i):
        return [m_inv[:, i, j, None, None] for j in range(3)]

    (a0, a1, a2), (b0, b1, b2) = row(0), row(1)
    src_x = a0 * xs + a1 * ys + a2
    src_y = b0 * xs + b1 * ys + b2
    sel_img, sel_mask = draws["apply"][:, None, None, None], draws["apply"][:, None, None]
    images = [torch.where(sel_img, _sample_bilinear(img.float(), src_y, src_x).to(img.dtype), img)
              for img in images]
    masks = [torch.where(sel_mask, _sample_nearest(m, src_y, src_x), m) for m in masks]
    return images, masks


# -- cutout ----------------------------------------------------------------------

def draw_cutout(g: torch.Generator, batch: int, h: int, w: int, p: float,
                num_holes: int = 8, size: int = 8) -> dict:
    return {"apply": _coin(g, p, (batch,)),
            "ys": torch.randint(0, h - size, (batch, num_holes), generator=g, device=g.device),
            "xs": torch.randint(0, w - size, (batch, num_holes), generator=g, device=g.device)}


def cutout(images: list, masks: list, draws: dict, size: int = 8):
    b, h, w = images[0].shape[:3]
    dev = images[0].device
    ys, xs = draws["ys"][:, None, None, :], draws["xs"][:, None, None, :]
    row = torch.arange(h, device=dev)[None, :, None, None]
    col = torch.arange(w, device=dev)[None, None, :, None]
    inside = ((row >= ys) & (row < ys + size) & (col >= xs) & (col < xs + size)).any(dim=-1)
    keep = ~(inside & draws["apply"][:, None, None])
    return [img * keep[..., None].to(img.dtype) for img in images], masks


# -- the pipeline -------------------------------------------------------------------

def _p(aug: dict, name: str) -> float:
    return float(aug.get(name, {}).get("p", 0.0))


def draw_augmentations(g: torch.Generator, batch: dict, config: dict,
                       batch_size: int | None = None) -> dict:
    """The draws of every configured operation with p > 0, in the
    pipeline's order: {operation: draws}, for ``batch_size`` samples
    (default the batch's)."""
    aug = config.get("augmentations") or {}
    images = [batch[k] for k in IMAGE_KEYS if k in batch]
    b, h, w = images[0].shape[:3]
    b = b if batch_size is None else batch_size
    draws: dict = {}
    rrc = aug.get("RandomResizedCrop", {})
    if _p(aug, "RandomResizedCrop") > 0:
        draws["RandomResizedCrop"] = draw_random_resized_crop(
            g, b, h, w, tuple(rrc.get("scale", (0.2, 1.0))), p=float(rrc["p"]))
        h = w = int(rrc.get("value", h))
    if _p(aug, "GaussianBlur") > 0:
        gb = aug["GaussianBlur"]
        draws["GaussianBlur"] = draw_gaussian_blur(g, b, float(gb["p"]),
                                                   tuple(gb.get("sigma_limit", (0.1, 2.0))))
    if _p(aug, "HorizontalFlip") > 0 or _p(aug, "VerticalFlip") > 0:
        draws["flips"] = draw_flips(g, b, _p(aug, "HorizontalFlip"), _p(aug, "VerticalFlip"))
    et = aug.get("ElasticTransform", {})
    if _p(aug, "ElasticTransform") > 0:
        draws["ElasticTransform"] = draw_elastic_transform(
            g, b, h, w, float(et["p"]), alpha_affine=float(et.get("alpha_affine", 50)),
            same_dxdy=bool(et.get("same_dxdy", False)))
    gn = aug.get("GaussianNoise", aug.get("GaussNoise", {}))
    if float(gn.get("p", 0)) > 0:
        draws["GaussNoise"] = draw_gauss_noise(g, [(b, h, w, im.shape[-1]) for im in images],
                                               float(gn["p"]))
    if _p(aug, "MultNoise") > 0:
        draws["MultNoise"] = draw_multiplicative_noise(g, images, _p(aug, "MultNoise"), batch=b)
    if _p(aug, "Cutout") > 0:
        draws["Cutout"] = draw_cutout(g, b, h, w, _p(aug, "Cutout"))
    return draws


def apply_augmentations(batch: dict, config: dict, draws: dict) -> dict:
    """The configured pipeline on a batch dict (paired across post, pre1,
    pre2, dem and mask, valid) with the given draws, in
    ``get_augmentations``' order; then discard-if-empty."""
    aug = config.get("augmentations") or {}
    image_keys = [k for k in IMAGE_KEYS if k in batch]
    mask_keys = [k for k in MASK_KEYS if k in batch]
    images = [batch[k] for k in image_keys]
    masks = [batch[k] for k in mask_keys]
    orig_images, orig_masks = images, masks

    if "RandomResizedCrop" in draws:
        out_size = int(aug["RandomResizedCrop"].get("value", images[0].shape[1]))
        images, masks = random_resized_crop(images, masks, out_size, draws["RandomResizedCrop"])
        b, h, w = orig_images[0].shape[:3]
        if out_size != h:
            # the discard-if-empty fallback lives in the output geometry: a
            # whole-image resize of the originals
            full = {"y0": torch.zeros(b, device=images[0].device),
                    "x0": torch.zeros(b, device=images[0].device),
                    "ch": torch.full((b,), float(h), device=images[0].device),
                    "cw": torch.full((b,), float(w), device=images[0].device)}
            orig_images, orig_masks = random_resized_crop(orig_images, orig_masks, out_size, full)
    if "GaussianBlur" in draws:
        images = gaussian_blur(images, draws["GaussianBlur"],
                               tuple(aug["GaussianBlur"].get("sigma_limit", (0.1, 2.0))))
    if "flips" in draws:
        images, masks = flips(images, masks, draws["flips"])
    if "ElasticTransform" in draws:
        et = aug["ElasticTransform"]
        images, masks = elastic_transform(
            images, masks, draws["ElasticTransform"], alpha=float(et.get("alpha", 1.0)),
            sigma=float(et.get("sigma", 50)), approximate=bool(et.get("approximate", True)))
    if "GaussNoise" in draws:
        images = gauss_noise(images, draws["GaussNoise"])
    if "MultNoise" in draws:
        images = multiplicative_noise(images, draws["MultNoise"])
    if "Cutout" in draws:
        images, masks = cutout(images, masks, draws["Cutout"])

    if "valid" in batch:
        has_valid = masks[mask_keys.index("valid")].sum(dim=(1, 2)) > 0
        images = [torch.where(has_valid[:, None, None, None], a, o)
                  for a, o in zip(images, orig_images)]
        masks = [torch.where(has_valid[:, None, None], a, o) for a, o in zip(masks, orig_masks)]

    out = dict(batch)
    out.update(zip(image_keys, images))
    out.update(zip(mask_keys, masks))
    return out


@torch.no_grad()
def augment_batch(g: torch.Generator, batch: dict, config: dict) -> dict:
    """The configured augmentation pipeline on a batch on ``g``'s device:
    draws from ``g``, then the applies. Raises on an unsupported operation
    configured with p > 0. Under data parallelism the draws are made for the
    global batch and cut to this rank's rows (``parallel/mesh.draw_rows``),
    so a rank augments its rows as one process augments the same rows."""
    if not config.get("augmentations"):
        return batch
    check_augmentations(config)
    local = next(batch[k] for k in IMAGE_KEYS if k in batch).shape[0]
    draws = draw_rows(lambda b: draw_augmentations(g, batch, config, batch_size=b), local)
    return apply_augmentations(batch, config, draws)
