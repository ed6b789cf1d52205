"""GeoTIFF tile decode + per-sample raw struct assembly; the port's own copy
of ``kurosiwo_tpu/data/tiles.py``.

Parity with the reference's `dataset/Dataset.py:641-768`:
  * per grid dir, files are selected by name prefix: MK0_MLU (label),
    MK0_MNA (valid mask), MS1_IVV/IVH (post/"flood"), SL1_IVV/IVH (pre1),
    SL2_IVV/IVH (pre2), MK0_DEM;
  * channel stack per acquisition: vv / vh / optional vh-vv ratio, then
    clamp to [0, clamp_input] and nan_to_num(clamp_input) (Dataset.py:148-169);
  * DEM: NaN interpolation then standardization; optional slope (Horn's
    method — the reference's richdem slope_riserun) computed before
    normalization (Dataset.py:731-768).

The reference pulls rioxarray/richdem onto the per-sample hot path; here DEM
interpolation + slope use numpy/scipy (same numerics) and are cheap relative
to decode. Tile decode is the native libtiff thread-pool decoder
(``data/native.py``) where it builds and libtiff loads, else cv2
IMREAD_ANYDEPTH like the reference, as the JAX package picks
(``tiles.py:60-87``): ``KUROSIWO_NATIVE_DECODE=0`` forces cv2, and cv2
takes a file the native decoder refuses with an ``IOError``.
``decoder_choice`` names the pick; the Loader prints it at its start.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np

PREFIXES = {
    "mask": "MK0_MLU",
    "valid": "MK0_MNA",
    "post_vv": "MS1_IVV",
    "post_vh": "MS1_IVH",
    "pre1_vv": "SL1_IVV",
    "pre1_vh": "SL1_IVH",
    "pre2_vv": "SL2_IVV",
    "pre2_vh": "SL2_IVH",
    "dem": "MK0_DEM",
}


@dataclasses.dataclass
class RawSample:
    """Decoded, pre-normalization sample (HWC float32 / HW int32)."""

    post: np.ndarray
    pre1: np.ndarray
    pre2: np.ndarray
    mask: np.ndarray
    valid: np.ndarray
    dem: np.ndarray | None
    clz: int
    activation: int


_USE_NATIVE: bool | None = None


def use_native() -> bool:
    """Whether tiles decode natively (decided once a process)."""
    global _USE_NATIVE
    if _USE_NATIVE is None:
        if os.environ.get("KUROSIWO_NATIVE_DECODE", "1") == "0":
            _USE_NATIVE = False
        else:
            from . import native

            _USE_NATIVE = native.available()
    return _USE_NATIVE


def decoder_choice() -> str:
    """The tile decoder this process uses, and why."""
    if use_native():
        return "native libtiff (csrc/tile_decoder.cpp)"
    if os.environ.get("KUROSIWO_NATIVE_DECODE", "1") == "0":
        return "cv2 (KUROSIWO_NATIVE_DECODE=0)"
    from . import native

    return f"cv2 (native decoder unavailable: {native.status()})"


def _imread(path: str) -> np.ndarray:
    """Tile decode: the native libtiff decoder where available (float32),
    else, or for a file it refuses, cv2 IMREAD_ANYDEPTH like the reference."""
    if use_native():
        from . import native

        try:
            return native.decode_tile(path)
        except IOError:
            pass  # exotic encodings: cv2
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"cannot decode {path}: reading GeoTIFF tiles needs cv2 (opencv), "
                          "which is not installed, where the native libtiff decoder does not "
                          "take the file") from e
    img = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    if img is None:
        raise IOError(f"failed to decode tile {path}")
    return img


def list_tile_files(grid_dir: str | os.PathLike) -> dict[str, str]:
    """Map logical tile name -> file path by prefix convention."""
    out = {}
    for fname in os.listdir(grid_dir):
        if "xml" in fname:
            continue
        for key, prefix in PREFIXES.items():
            if fname.startswith(prefix):
                out[key] = str(Path(grid_dir) / fname)
    return out


def stack_channels(vv: np.ndarray, vh: np.ndarray, channels: list, clamp: float | None) -> np.ndarray:
    """vv/vh[/ratio] channel stack + clamp + nan_to_num, HWC float32
    (reference `concat`, Dataset.py:148-169, NCHW there)."""
    chs = set(channels)
    if chs == {"vv", "vh", "vh/vv"}:
        eps = 1e-7
        img = np.stack([vv, vh, vh / (vv + eps)], axis=-1)
    elif chs == {"vv", "vh"}:
        img = np.stack([vv, vh], axis=-1)
    elif channels == ["vh"]:
        img = vh[..., None]
    else:
        raise ValueError(f"unsupported channels {channels}")
    img = img.astype(np.float32)
    if clamp is not None:
        img = np.clip(img, 0.0, clamp)
        img = np.nan_to_num(img, nan=clamp)
    else:
        img = np.nan_to_num(img, nan=200.0)
    return img


def interpolate_nan(dem: np.ndarray) -> np.ndarray:
    """Nearest-neighbor NaN fill (rioxarray interpolate_na equivalent)."""
    nans = np.isnan(dem)
    if not nans.any():
        return dem
    from scipy import ndimage

    idx = ndimage.distance_transform_edt(nans, return_distances=False, return_indices=True)
    return dem[tuple(idx)]


def horn_slope(dem: np.ndarray) -> np.ndarray:
    """Slope as rise/run via Horn's method (richdem TerrainAttribute
    "slope_riserun" numerics): 3x3 weighted central differences, magnitude of
    the gradient, unit cell size."""
    z = np.pad(dem.astype(np.float64), 1, mode="edge")
    dzdx = (
        (z[:-2, 2:] + 2 * z[1:-1, 2:] + z[2:, 2:])
        - (z[:-2, :-2] + 2 * z[1:-1, :-2] + z[2:, :-2])
    ) / 8.0
    dzdy = (
        (z[2:, :-2] + 2 * z[2:, 1:-1] + z[2:, 2:])
        - (z[:-2, :-2] + 2 * z[:-2, 1:-1] + z[:-2, 2:])
    ) / 8.0
    return np.sqrt(dzdx**2 + dzdy**2).astype(np.float32)


def read_dem(path: str, config: dict) -> np.ndarray:
    """DEM (or slope) channel, standardized when scale_input is set. HW1."""
    dem = _imread(path).astype(np.float32)
    dem = interpolate_nan(dem)
    if config.get("slope"):
        if not config.get("dem"):
            raise ValueError("To return the slope the DEM option must be enabled.")
        s = horn_slope(dem)
        if config.get("scale_input") is not None:
            s = (s - config["slope_mean"]) / config["slope_std"]
        return s[..., None]
    if config.get("scale_input") is not None:
        dem = (dem - config["dem_mean"]) / config["dem_std"]
    return dem[..., None]


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """uint8 mode (Dataset.py:674-679): scale each raster by its max to
    [0, 255] and quantize.

    Hardened like slc._maybe_uint8: this runs BEFORE stack_channels'
    nan_to_num, so scattered NaNs reach the cast — img.max() is then NaN
    (skipping the scale) and NaN->uint8 is C-undefined, platform-dependent
    garbage. NaNs are replaced and the value range clipped before the cast
    (fill 0 = nodata/darkest, same choice as the SLC path); the reference
    has the same latent UB."""
    m = float(np.nanmax(img)) if np.isfinite(img).any() else 1.0
    if not np.isfinite(m) or m <= 0.0:
        m = 1.0
    scaled = np.nan_to_num(img / m * 255.0, nan=0.0, posinf=255.0, neginf=0.0)
    return np.clip(scaled, 0.0, 255.0).astype(np.uint8).astype(np.float32)


def read_raw_sample(root_path: str, record, config: dict) -> RawSample:
    """Decode every tile of one grid dir into a RawSample (no normalization —
    that runs on device)."""
    grid_dir = Path(root_path) / "data" / record.path if not os.path.isabs(record.path) else record.path
    files = list_tile_files(grid_dir)
    channels = config["channels"]
    clamp = config.get("clamp_input")

    # decode only the polarizations the channel stack consumes — with
    # channels=["vh"] the three vv decodes were pure wasted I/O on the
    # per-sample hot path
    need_vv = any(c in ("vv", "vh/vv") for c in channels)
    need_vh = any(c in ("vh", "vh/vv") for c in channels)

    def pol(key, needed=True):
        if not needed:
            return None
        img = _imread(files[key])
        return _to_uint8(img) if config.get("uint8") else img

    post = stack_channels(pol("post_vv", need_vv), pol("post_vh", need_vh), channels, clamp)
    pre1 = stack_channels(pol("pre1_vv", need_vv), pol("pre1_vh", need_vh), channels, clamp)
    pre2 = stack_channels(pol("pre2_vv", need_vv), pol("pre2_vh", need_vh), channels, clamp)
    mask = (
        _imread(files["mask"]).astype(np.int32)
        if "mask" in files
        else np.zeros(post.shape[:2], np.int32)
    )
    valid = (
        _imread(files["valid"]).astype(np.int32)
        if "valid" in files
        else np.ones(post.shape[:2], np.int32)
    )
    if config.get("slope") and not config.get("dem"):
        # the reference errors here too (Dataset.py:741-745 exit(2)); without
        # this the requested slope channel would silently be absent
        raise ValueError("config requests slope=true but dem=false — slope is derived from the DEM")
    dem = None
    if config.get("dem") and "dem" in files:
        dem = read_dem(files["dem"], config)
    return RawSample(post, pre1, pre2, mask, valid, dem, int(record.clz), int(record.activation))
