"""SLC (single-look-complex) loader; the port's own copy of
``kurosiwo_tpu/data/slc.py``. A batch is bitwise the JAX ``SLCLoader``'s for
the same config and seed.

Parity with SLCDataset (the reference's ``dataset/Dataset.py:986-1228``):
  * records come from a JSON index (list/dict of {actid, path, aoiid, clz})
    instead of the GRD pickle; the same activation-split filtering; val and
    test share ``test_json``;
  * per sample: 4-channel SLC rasters for MS1 (post), SL1 (pre1), SL2
    (pre2); MK0_MLU / MK0_MNA masks through ``tiles._imread``;
  * tiles other than 224 are padded CENTRED to 224 with the INT-truncated
    flood mean (the mask padded with 3 = invalid), as albumentations
    PadIfNeeded(border_mode=CONSTANT, value=int(flood.mean())) does
    (Dataset.py:1177-1184);
  * "normalize" scaling with the 4-vector slc_mean / slc_std statistics;
  * DEM: the nodata sentinel -> NaN -> interpolated; slc_dem or slc_slope
    statistics.

Multi-band GeoTIFFs decode with cv2.imreadmulti; the bands stack to HWC.
The rows are decoded by the Loader's decode processes into its ring of
batch buffers (``pipeline.BatchRing``), as the GRD loader's are.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from .index import Record
from .normalize import normalize
from .pipeline import Loader, SampleDecoder, epoch_rng, resolve_process_grid
from .tiles import RawSample, _imread, horn_slope, interpolate_nan


def read_multiband(path: str) -> np.ndarray:
    """A 4-band SLC raster -> (H, W, 4) float32."""
    import cv2 as cv

    ok, mats = cv.imreadmulti(path, flags=cv.IMREAD_ANYDEPTH | cv.IMREAD_UNCHANGED)
    if ok and len(mats) > 1:
        return np.stack(mats, axis=-1).astype(np.float32)
    img = cv.imread(path, cv.IMREAD_ANYDEPTH | cv.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"failed to decode SLC raster {path}")
    img = img.astype(np.float32)
    return img if img.ndim == 3 else img[..., None]


def pad_to(img: np.ndarray, size: int, value: float) -> np.ndarray:
    """Pad to (size, size) with a constant, the image centred (PadIfNeeded
    with border_mode=CONSTANT: the odd pixel goes bottom and right)."""
    h, w = img.shape[:2]
    if h >= size and w >= size:
        return img
    top = max((size - h) // 2, 0)
    bottom = max(size - h - top, 0)
    left = max((size - w) // 2, 0)
    right = max(size - w - left, 0)
    pad_width = [(top, bottom), (left, right)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad_width, mode="constant", constant_values=value)


def load_slc_records(json_path: str, valid_acts: list, track: str) -> list[Record]:
    with open(json_path) as f:
        grids = json.load(f)
    items = grids.items() if isinstance(grids, dict) else enumerate(grids)
    records = []
    for key, g in items:
        activation = g["actid"]
        aoi = g.get("aoiid", 0)
        act_aoi = f"{activation}_{aoi:02}" if track == "Climatic" else activation
        if act_aoi not in valid_acts:
            continue
        records.append(
            Record(id=f"{key:08x}" if isinstance(key, int) else str(key), path=g["path"],
                   clz=g.get("clz", 1), activation=activation, aoi=aoi)
        )
    return records


def _maybe_uint8(img: np.ndarray, cfg: dict) -> np.ndarray:
    """The reference's uint8 quantization of an SLC raster
    (Dataset.py:1113-1134): scaled by its max to [0, 255] and truncated.
    An all-NaN raster scales by 1; NaNs become 0 and the range is clipped
    before the cast, so the cast is defined (the JAX package's hardening)."""
    if not cfg.get("uint8"):
        return img
    m = float(np.nanmax(img)) if np.isfinite(img).any() else 1.0
    if not np.isfinite(m) or m <= 0.0:
        m = 1.0
    scaled = np.nan_to_num(img / m * 255.0, nan=0.0, posinf=255.0, neginf=0.0)
    return np.clip(scaled, 0.0, 255.0).astype(np.uint8).astype(np.float32)


class SLCDecoder(SampleDecoder):
    """A record -> its processed SLC sample dict. Picklable, so each decode
    process holds a copy."""

    def read(self, record: Record) -> RawSample:
        cfg = self.config
        if self.synthetic:
            from .synthetic import synthetic_raw_sample

            size = int(cfg.get("synthetic_patch_size", 224))
            raw = synthetic_raw_sample(record, cfg, size=size, seed=self.seed)

            def widen(a):  # 4 channels, as real SLC rasters have
                return np.concatenate([a, a], axis=-1)

            return RawSample(widen(raw.post), widen(raw.pre1), widen(raw.pre2),
                             raw.mask, raw.valid, raw.dem, raw.clz, raw.activation)

        grid_dir = Path(cfg.get("slc_root_path", ".")) / record.path
        mask = valid = dem = None
        flood = sec1 = sec2 = None
        for fname in sorted(os.listdir(grid_dir)):
            if "xml" in fname:
                continue
            p = str(grid_dir / fname)
            if fname.startswith("MK0_MLU"):
                mask = _imread(p).astype(np.int32)
            elif fname.startswith("MK0_MNA"):
                valid = _imread(p).astype(np.int32)
            elif fname.startswith("MS1"):
                flood = _maybe_uint8(read_multiband(p), cfg)
            elif fname.startswith("SL1"):
                sec1 = _maybe_uint8(read_multiband(p), cfg)
            elif fname.startswith("SL2"):
                sec2 = _maybe_uint8(read_multiband(p), cfg)
            elif fname.startswith("MK0_DEM"):
                d = _imread(p).astype(np.float32)
                # the SLC nodata is a large sentinel, not NaN (Dataset.py:1140-1152)
                if d.size:
                    sentinel = d.max()
                    if sentinel > 1e30:
                        d = np.where(d == sentinel, np.nan, d)
                d = interpolate_nan(d)
                if cfg.get("slope"):
                    d = horn_slope(d)
                    if cfg.get("scale_input") is not None:
                        d = (d - cfg["slc_slope_mean"]) / cfg["slc_slope_std"]
                elif cfg.get("scale_input") is not None:
                    d = (d - cfg["slc_dem_mean"]) / cfg["slc_dem_std"]
                dem = d[..., None]
        if mask is None:
            mask = np.zeros(flood.shape[:2], np.int32)
        if valid is None:
            valid = np.ones(flood.shape[:2], np.int32)
        # ragged tiles padded to 224: the image with the INT-truncated flood
        # mean (the reference passes value=int(flood.mean()) to PadIfNeeded,
        # Dataset.py:1181, and reuses that one pad for sec1 and sec2), the
        # mask with 3
        if flood.shape[:2] != (224, 224):
            mval = float(int(np.nan_to_num(flood).mean()))
            flood, sec1, sec2 = (pad_to(a, 224, mval) for a in (flood, sec1, sec2))
            mask = pad_to(mask, 224, 3)
            valid = pad_to(valid, 224, 0)
            if dem is not None:
                dem = pad_to(dem, 224, 0.0)
        return RawSample(flood, sec1, sec2, mask, valid, dem, int(record.clz),
                         int(record.activation))

    def process(self, record: Record) -> dict:
        raw = self.read(record)
        cfg = self.config
        out: dict = {}
        if cfg.get("scale_input") == "normalize":
            mean, std = cfg["slc_mean"], cfg["slc_std"]
            nch = raw.post.shape[-1]
            mean, std = np.resize(mean, nch), np.resize(std, nch)
            for key, img in (("post", raw.post), ("pre1", raw.pre1), ("pre2", raw.pre2)):
                out[key] = normalize(img, mean, std).astype(np.float32)
            for name in ("flood", "pre1", "pre2"):
                out[f"{name}_sv1"] = np.asarray(mean, np.float32)
                out[f"{name}_sv2"] = np.asarray(std, np.float32)
        else:
            out["post"], out["pre1"], out["pre2"] = raw.post, raw.pre1, raw.pre2
        out["mask"] = raw.mask.astype(np.int32)
        out["valid"] = raw.valid.astype(np.int32)
        if cfg.get("dem"):
            out["dem"] = (
                raw.dem.astype(np.float32)
                if raw.dem is not None
                else np.zeros(raw.post.shape[:2] + (1,), np.float32)
            )
        out["clz"] = np.int32(raw.clz)
        out["activation"] = np.int32(raw.activation)
        out["sample_weight"] = np.float32(1.0)
        return out


class SLCLoader(Loader):
    """The Loader over SLC records; its batch struct is the GRD loader's,
    with 4-channel acquisitions. No oversampling and no packed shards, as
    in the JAX package."""

    def __init__(self, mode: str, config: dict, seed: int = 999,
                 synthetic: bool | None = None, process_index: int | None = None,
                 process_count: int | None = None):
        self.mode = mode
        self.config = config
        self.batch_size = int(config["batch_size"])
        self.process_index, self.process_count, self.local_batch_size = resolve_process_grid(
            self.batch_size, process_index, process_count)
        self.seed = seed
        self.workers = int(config.get("num_workers", 8)) or 1
        root = Path(config.get("slc_root_path") or ".")
        if synthetic is None:
            synthetic = bool(config.get("synthetic_data")) or not root.exists() or not str(
                config.get("slc_root_path") or "")
        self.synthetic = synthetic
        split = "train" if mode == "train" else mode
        if synthetic:
            from .synthetic import synthetic_records

            n = int(config.get("synthetic_size", {"train": 256}.get(mode, 64)))
            self.records = synthetic_records(n, list(config.get(f"{split}_acts") or [130]), seed)
        else:
            json_path = config["train_json"] if mode == "train" else config["test_json"]
            self.records = load_slc_records(json_path, config[f"{split}_acts"],
                                            config.get("track", "RandomEvents"))
        self.positive_records = list(self.records)
        self.negative_records = []
        self.stats = None
        self.shard_reader = None
        self.decoder = SLCDecoder(config, self.records, None, seed, synthetic)
        self.oversampling = False
        self._rng = epoch_rng(seed, mode)
        self._epoch = 0
        self._oversample_ids = None
        self._ring = self._workers = self._finalizer = self._feeder = None
