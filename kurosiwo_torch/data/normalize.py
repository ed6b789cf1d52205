"""Input scaling modes; the port's own copy of
``kurosiwo_tpu/data/normalize.py`` (numpy only, host side).

Parity with the reference's `dataset/Dataset.py:192-484` (`scale_img`) and
`:486-639` (`update_min_max_stats` + stats.pkl cache):

  "normalize"   per-channel (x - mean) / std with the dataset GRD stats —
                the default and what the released checkpoints used;
  "min-max"     per-activation per-image-type min/max (max replaced by
                clamp_input when clamping is on);
  [lo, hi]      explicit range: min-max then affine to [lo, hi];
  "custom"      offset-to-positive -> log -> min-max -> 2-98% percentile
                contrast stretch to [0,1] (torchio RescaleIntensity numerics).

All modes return (scale_var_1, scale_var_2, scaled) like the reference so the
6/12-tuple surface and `reverse_scale_img` keep working.

The loader applies the selected mode on the host, per sample.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

IMG_NAMES = ("flood", "pre1", "pre2")


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """Per-channel standardization; img is HWC."""
    mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, -1)
    return (img - mean) / std


def _min_max_bounds(stats: dict, activation, img_name: str, channels: list, clamp: float | None):
    """Per-channel (mins, maxs) from the per-activation stats table.

    Reference quirk kept (Dataset.py:200-276): with clamping on, the
    MULTI-channel branch caps the vh/vv ratio at 1.0 (Dataset.py:229-231)
    while the SINGLE-channel ["vh/vv"] branch caps it at clamp_input
    (Dataset.py:263-264) — the asymmetry is the reference's, not ours."""
    a = stats[activation]
    single = len(channels) == 1
    mins, maxs = [], []
    for ch in channels:
        if ch == "vh/vv":
            lo = a[f"{img_name}_vh"][0] / a[f"{img_name}_vv"][0]
            if clamp is not None:
                hi = clamp if single else 1.0
            else:
                hi = a[f"{img_name}_vh"][1] / a[f"{img_name}_vv"][1]
        else:
            lo = a[f"{img_name}_{ch}"][0]
            hi = clamp if clamp is not None else a[f"{img_name}_{ch}"][1]
        mins.append(float(lo))
        maxs.append(float(hi))
    return mins, maxs


def min_max_scale(img: np.ndarray, stats: dict, activation, img_name: str, channels: list, clamp):
    mins, maxs = _min_max_bounds(stats, activation, img_name, channels, clamp)
    lo = np.asarray(mins, np.float32).reshape(1, 1, -1)
    hi = np.asarray(maxs, np.float32).reshape(1, 1, -1)
    return mins, maxs, (img - lo) / (hi - lo)


def range_scale(img, stats, activation, img_name, channels, clamp, out_range):
    mins, maxs, scaled = min_max_scale(img, stats, activation, img_name, channels, clamp)
    lo, hi = float(out_range[0]), float(out_range[1])
    return mins, maxs, scaled * (hi - lo) + lo


def rescale_intensity(x: np.ndarray, percentiles=(2, 98), out_min_max=(0.0, 1.0)) -> np.ndarray:
    """torchio RescaleIntensity numerics: clip to the percentile window then
    affine to out range."""
    lo, hi = np.percentile(x, percentiles)
    if hi - lo < 1e-12:
        return np.zeros_like(x) + out_min_max[0]
    y = np.clip(x, lo, hi)
    y = (y - lo) / (hi - lo)
    return y * (out_min_max[1] - out_min_max[0]) + out_min_max[0]


def custom_scale(img: np.ndarray, valid_mask: np.ndarray, stats, activation, img_name, channels, clamp):
    """log + min-max + contrast stretch (Dataset.py:356-484)."""
    eps = 1e-7
    mins, maxs = _min_max_bounds(stats, activation, img_name, channels, clamp)
    c = img.shape[-1]
    out = []
    for ci in range(c):
        x = img[..., ci]
        offset = x[valid_mask.astype(bool)].min() if valid_mask.any() else x.min()
        xs = x + (-offset) + eps if offset <= 0 else x
        xs = np.log(xs)
        xs = (xs - mins[ci]) / (maxs[ci] - mins[ci])
        out.append(rescale_intensity(xs))
    return mins, maxs, np.stack(out, axis=-1).astype(np.float32)


def scale_img(img: np.ndarray, valid_mask, img_name: str, activation, config: dict, stats: dict | None):
    """Dispatch over scale_input; img is HWC float32. Returns (v1, v2, scaled)."""
    mode = config.get("scale_input")
    channels = config["channels"]
    clamp = config.get("clamp_input")
    if mode == "normalize":
        return config["data_mean"], config["data_std"], normalize(img, config["data_mean"], config["data_std"])
    if mode == "min-max":
        return min_max_scale(img, stats, activation, img_name, channels, clamp)
    if isinstance(mode, (list, tuple)):
        return range_scale(img, stats, activation, img_name, channels, clamp, mode)
    if mode == "custom":
        return custom_scale(img, valid_mask, stats, activation, img_name, channels, clamp)
    raise ValueError(f"unknown scale_input {mode!r}")


def compute_min_max_stats(records, root_path: str, config: dict, cache_path: str = "stats.pkl") -> dict:
    """Per-activation masked min/max over all image types, cached to
    stats.pkl (Dataset.py:486-639). `records` must span train+val+test."""
    p = Path(cache_path)
    if p.exists():
        with open(p, "rb") as f:
            return pickle.load(f)
    # Guard the cache against the reference's shared-file race (SURVEY.md
    # §5.2: whichever Dataset instance runs first wins, others may read a
    # partial file): exclusive-lock a sidecar, re-check, write atomically.
    import fcntl

    lock_path = p.with_suffix(p.suffix + ".lock")
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if p.exists():  # another process computed it while we waited
            with open(p, "rb") as f:
                return pickle.load(f)
        stats = _compute_min_max_stats_locked(records, root_path, config)
        tmp = p.with_suffix(p.suffix + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(stats, f)
        tmp.replace(p)  # atomic on POSIX
        return stats


def _compute_min_max_stats_locked(records, root_path: str, config: dict) -> dict:
    from .tiles import _imread, list_tile_files

    stats: dict = {}
    name_map = {"flood": ("post_vv", "post_vh"), "pre1": ("pre1_vv", "pre1_vh"), "pre2": ("pre2_vv", "pre2_vh")}
    for rec in records:
        gdir = Path(root_path) / "data" / rec.path
        files = list_tile_files(gdir)
        valid = _imread(files["valid"]) == 1
        a = stats.setdefault(rec.activation, {})
        for img_name, (kv, kh) in name_map.items():
            for pol, key in (("vv", kv), ("vh", kh)):
                img = _imread(files[key])
                vals = img[valid]
                if vals.size == 0:
                    continue
                lo, hi = float(vals.min()), float(vals.max())
                k = f"{img_name}_{pol}"
                if k in a:
                    a[k] = (min(a[k][0], lo), max(a[k][1], hi))
                else:
                    a[k] = (lo, hi)
    return stats


def reverse_scale_img(img: np.ndarray, x1, x2, config: dict) -> np.ndarray:
    """Inverse of scale_img for visualization (utilities/utilities.py:129-226).
    img is HWC (or NHWC); x1/x2 are the per-channel scale vars."""
    x1 = np.asarray(x1, np.float32).reshape((1,) * (img.ndim - 1) + (-1,))
    x2 = np.asarray(x2, np.float32).reshape((1,) * (img.ndim - 1) + (-1,))
    mode = config.get("scale_input")
    if mode == "normalize":
        return img * x2 + x1
    if mode in ("min-max", "custom"):
        return img * (x2 - x1) + x1
    if isinstance(mode, (list, tuple)):
        lo, hi = float(mode[0]), float(mode[1])
        return (img - lo) / (hi - lo) * (x2 - x1) + x1
    return img
