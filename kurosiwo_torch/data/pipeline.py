"""Prefetching host loader -> fixed batch structs of numpy arrays; the port's
own copy of ``kurosiwo_tpu/data/pipeline.py``. A batch is bitwise the JAX
loader's for the same config and seed: the same records, the same seeded
draws, the same decode and padding.

A thread pool decodes samples, a seeded sampler picks indices (50/50
positive/negative oversampling, Dataset.py:641-651, from a dedicated
``np.random.Generator``), and batches are assembled as contiguous NHWC
arrays, double-buffered ahead of the step. The engine's ``device_prefetch``
moves them to the card.

Batch struct (numpy, NHWC):
  post, pre1, pre2 : (B, H, W, C) float32   — scaled acquisitions
  mask             : (B, H, W)    int32     — labels {0,1,2,3}
  valid            : (B, H, W)    int32
  dem              : (B, H, W, 1) float32   — only when config["dem"]
  clz, activation  : (B,) int32
  sample_weight    : (B,) float32           — 0 for eval padding samples
  *_sv1/_sv2       : (B, C) float32         — scale vars when scale_input set

Eval splits pad the final partial batch to full size (sample_weight 0, mask
all-ignore), so every eval batch has the step's shape.

One process decodes the whole batch: the JAX loader's process grid is
process 0 of 1 here until the port has a multi-process runtime
(ROADMAP.md, A12).

Not ported: packed shards (``data/shards.py``) and the SLC loader
(``data/slc.py``), ROADMAP.md A14; the diffusion task's per-observation
records, A10.
"""

from __future__ import annotations

import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator

import numpy as np

from .index import GridIndex, Record
from .normalize import compute_min_max_stats, scale_img
from .synthetic import synthetic_raw_sample, synthetic_records
from .tiles import RawSample, read_raw_sample


def _needs_stats(config) -> bool:
    mode = config.get("scale_input")
    return mode in ("min-max", "custom") or isinstance(mode, (list, tuple))


def epoch_rng(seed: int, mode: str) -> np.random.Generator:
    """Per-split epoch rng. zlib.crc32, NOT hash(): str hash is salted per
    process (PYTHONHASHSEED)."""
    return np.random.default_rng(seed + zlib.crc32(mode.encode()) % 65536)


class Loader:
    """Iterable over batches for one split."""

    def __init__(
        self,
        mode: str,
        config: dict,
        seed: int = 999,
        index_cache: dict | None = None,
    ):
        if config.get("task") == "diffusion-unsup":
            raise NotImplementedError("the diffusion task's per-observation loader is not ported "
                                      "yet (ROADMAP.md, A10)")
        if config.get("packed_shards"):
            raise NotImplementedError("packed_shards (data/shards.py) is not ported yet "
                                      "(ROADMAP.md, A14)")
        self.mode = mode
        self.config = config
        self.batch_size = int(config["batch_size"])
        self.seed = seed
        self.workers = int(config.get("num_workers", 8)) or 1

        root = Path(config.get("root_path", "."))
        self.synthetic = bool(config.get("synthetic_data")) or not (root / "data").exists()

        if self.synthetic:
            if _needs_stats(config):
                # synthetic activation ids are in no per-activation stats table
                raise ValueError(
                    f"scale_input={config.get('scale_input')!r} needs per-activation "
                    "min/max stats, which do not exist for the synthetic data source "
                    "(corpus missing or synthetic_data=true); use scale_input="
                    "\"normalize\" or null for synthetic runs"
                )
            n = int(config.get("synthetic_size", {"train": 256, "val": 64, "test": 64}.get(mode, 64)))
            acts = config.get(f"{mode}_acts") or [130]
            self.records = synthetic_records(n, list(acts), seed)
            self.positive_records = [r for r in self.records if r.positive]
            self.negative_records = [r for r in self.records if not r.positive]
            self.stats = None
        else:
            # one GridIndex per split, shared across the three Loaders
            cache = index_cache if index_cache is not None else {}
            if mode not in cache:
                cache[mode] = GridIndex(mode, config)
            index = cache[mode]
            self.records = index.records
            self.positive_records = index.positive_records
            self.negative_records = index.negative_records
            self.stats = None
            if _needs_stats(config):
                # the stats corpus spans ALL splits (reference
                # update_min_max_stats walks train+val+test, Dataset.py:493-520)
                all_records = []
                for m in ("train", "val", "test"):
                    if m not in cache:
                        cache[m] = GridIndex(m, config)
                    all_records.extend(cache[m].records)
                self.stats = compute_min_max_stats(all_records, str(root), config)

        self.oversampling = bool(config.get("oversampling")) and mode == "train"
        self._rng = epoch_rng(seed, mode)
        self._epoch = 0
        self._oversample_ids = None

    # -- sampling ---------------------------------------------------------
    def __len__(self):
        n = len(self.records)
        if self.mode == "train":
            return n // self.batch_size  # drop_last=True parity
        return -(-n // self.batch_size)

    def num_samples(self):
        return len(self.records)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.records)
        if self.mode != "train":
            return np.arange(n)
        if self.oversampling and self.negative_records and self.positive_records:
            # 50/50 positive/negative draws, seeded (Dataset.py:641-651); a
            # split with either side empty takes a plain shuffle
            if self._oversample_ids is None:
                by_id = {id(r): i for i, r in enumerate(self.records)}
                self._oversample_ids = (
                    np.asarray([by_id[id(r)] for r in self.positive_records]),
                    np.asarray([by_id[id(r)] for r in self.negative_records]),
                )
            pos_ids, neg_ids = self._oversample_ids
            coin = self._rng.integers(0, 2, n)
            pos_draw = pos_ids[self._rng.integers(0, len(pos_ids), n)]
            neg_draw = neg_ids[self._rng.integers(0, len(neg_ids), n)]
            return np.where(coin == 0, pos_draw, neg_draw)
        return self._rng.permutation(n)

    # -- decode -----------------------------------------------------------
    def _read(self, record: Record) -> RawSample:
        if self.synthetic:
            size = int(self.config.get("synthetic_patch_size", 224))
            return synthetic_raw_sample(record, self.config, size=size, seed=self.seed)
        return read_raw_sample(str(self.config.get("root_path", ".")), record, self.config)

    def _process(self, record: Record) -> dict:
        raw = self._read(record)
        cfg = self.config
        out: dict = {}
        if cfg.get("scale_input") is not None:
            valid_bool = raw.valid == 1
            sv = {}
            for name, img in (("flood", raw.post), ("pre1", raw.pre1), ("pre2", raw.pre2)):
                v1, v2, scaled = scale_img(img, valid_bool, name, raw.activation, cfg, self.stats)
                sv[name] = (np.asarray(v1, np.float32), np.asarray(v2, np.float32))
                out[{"flood": "post", "pre1": "pre1", "pre2": "pre2"}[name]] = scaled.astype(np.float32)
            for name in ("flood", "pre1", "pre2"):
                out[f"{name}_sv1"], out[f"{name}_sv2"] = sv[name]
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

    @staticmethod
    def _collate(samples: list[dict]) -> dict:
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _pad(self, samples: list[dict], target: int) -> list[dict]:
        """Pad eval batches to ``target`` with zero-weight copies (sample
        weight 0, mask all-ignore: numerically inert)."""
        pad = target - len(samples)
        if pad <= 0:
            return samples
        filler = {k: np.copy(v) for k, v in samples[-1].items()}
        filler["sample_weight"] = np.float32(0.0)
        filler["mask"] = np.full_like(filler["mask"], 3)  # all-ignore
        return samples + [filler] * pad

    # -- iteration --------------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        self._epoch += 1
        bs = self.batch_size
        batches = [indices[i : i + bs] for i in range(0, len(indices), bs)]
        if self.mode == "train":
            batches = [b for b in batches if len(b) == bs]

        def produce(pool, batch_ids):
            samples = list(pool.map(lambda i: self._process(self.records[int(i)]), batch_ids))
            if self.mode != "train":
                samples = self._pad(samples, bs)
            return self._collate(samples)

        yield from prefetch_epoch(batches, produce, self.workers)


def prefetch_epoch(batches, produce, workers: int):
    """Double-buffered threaded prefetch: decode batch k+1 while k trains.
    Decode errors are re-raised in the consumer (a feeder that died silently
    would truncate the epoch); an abandoned iterator (early break, a step's
    exception, GC) sets ``abandoned`` so the feeder never blocks forever on a
    full queue; one pool serves the whole epoch.
    ``produce(pool, batch_ids) -> batch dict``."""
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = object()
    abandoned = threading.Event()

    def put_until_abandoned(item) -> None:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                pass

    def feeder():
        try:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for b in batches:
                    if abandoned.is_set():
                        return
                    put_until_abandoned(produce(pool, b))
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            put_until_abandoned(("__loader_error__", e))
        finally:
            put_until_abandoned(stop)

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "__loader_error__":
                raise item[1]
            yield item
    finally:
        abandoned.set()
        try:  # unblock a feeder waiting on the full queue
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=10)


def prepare_loaders(config: dict, seed: int = 999):
    """Train/val/test loader triple (utilities/utilities.py:73-126 parity;
    only the RandomEvents track is supported, like the reference)."""
    if config.get("track") not in ("RandomEvents",):
        raise ValueError("No such track! We currently support only RandomEvents")
    if config.get("slc"):
        raise NotImplementedError("the SLC loader (data/slc.py) is not ported yet "
                                  "(ROADMAP.md, A14)")
    cache: dict = {}  # share split indices across the three Loaders
    return (
        Loader("train", config, seed, index_cache=cache),
        Loader("val", config, seed, index_cache=cache),
        Loader("test", config, seed, index_cache=cache),
    )
