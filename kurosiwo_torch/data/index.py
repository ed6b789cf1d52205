"""Grid-index readers and record building; the port's own copy of
``kurosiwo_tpu/data/index.py`` (numpy and the standard library only).

Parity with the reference's `dataset/Dataset.py:26-143`:
  * the GRD index is a gzip-compressed pickle mapping grid-hex -> {path, info
    {actid, aoiid, ...}, clz, clz_name} (written by catalogue/catalogue.py);
  * records are filtered by the mode's activation list (train_acts /
    val_acts / test_acts); val and test BOTH read `test_pickle` (reference
    quirk, Dataset.py:61-66 — the split is purely by activation id);
  * the Climatic track keys records by "actid_aoiid" (zero-padded);
  * oversampling mode keeps positive/negative record lists separately
    (negatives come from `negative_pickle`).

SLC indices are plain JSON lists of {actid, path, aoiid, clz}
(Dataset.py:1023).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import pickle
from pathlib import Path
from typing import Any


_GRID_INDEX_CACHE: dict[tuple, dict] = {}


def load_grid_index(path: str | os.PathLike) -> dict:
    """gzip-pickle loader (compress_pickle-compatible for .gz files).

    Memoized per (path, mtime, size): three Loaders that each need min-max
    stats walk all three splits' indices (up to 9 decompressions of a
    ~700k-entry pickle on the real corpus) — one decode per file suffices.
    """
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"grid index pickle not found: {p}")
    st = p.stat()
    key = (str(p.resolve()), st.st_mtime_ns, st.st_size)
    if key in _GRID_INDEX_CACHE:
        return _GRID_INDEX_CACHE[key]
    opener = gzip.open if p.suffix in (".gz", ".gzip") else open
    with opener(p, "rb") as f:
        grids = pickle.load(f)
    if len(_GRID_INDEX_CACHE) >= 4:  # bound: the corpus has 3 split files
        _GRID_INDEX_CACHE.pop(next(iter(_GRID_INDEX_CACHE)))
    _GRID_INDEX_CACHE[key] = grids
    return grids


def load_slc_index(path: str | os.PathLike) -> list[dict]:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Record:
    id: str
    path: str
    clz: int
    activation: Any
    aoi: Any
    positive: bool = True
    type: str | None = None  # diffusion-unsup splits each grid into pre1/pre2/flood


def build_records(
    grid_dict: dict,
    valid_acts: list,
    track: str = "RandomEvents",
    positive_keys: set | None = None,
    task: str | None = None,
) -> tuple[list[Record], dict, dict]:
    """Filter grids by activation split; returns (records, clz_stats, act_stats)."""
    records: list[Record] = []
    clz_stats = {1: 0, 2: 0, 3: 0}
    act_stats: dict = {}
    for key, g in grid_dict.items():
        activation = g["info"]["actid"]
        aoi = g["info"]["aoiid"]
        act_aoi = f"{activation}_{aoi:02}" if track == "Climatic" else activation
        if act_aoi not in valid_acts:
            continue
        clz = g.get("clz", 1)
        clz_stats[clz] = clz_stats.get(clz, 0) + 1
        act_stats[act_aoi] = act_stats.get(act_aoi, 0) + 1
        positive = positive_keys is None or key in positive_keys
        if task == "diffusion-unsup":
            for t in ("pre1", "pre2", "flood"):
                records.append(Record(key, g["path"], clz, activation, aoi, positive, t))
        else:
            records.append(Record(key, g["path"], clz, activation, aoi, positive))
    return records, clz_stats, act_stats


class GridIndex:
    """Mode-aware index: picks pickle + activation list per split and builds
    the (positive, negative) record partition for oversampling."""

    def __init__(self, mode: str, config: dict):
        self.mode = mode
        self.config = config
        if mode == "train":
            valid_acts = config["train_acts"]
            pickle_path = config["train_pickle"]
        elif mode == "val":
            valid_acts = config["val_acts"]
            pickle_path = config["test_pickle"]
        else:
            valid_acts = config["test_acts"]
            pickle_path = config["test_pickle"]
        grids = load_grid_index(pickle_path)
        positive_keys = set(grids.keys())
        total = dict(grids)
        if config.get("oversampling") and mode == "train" and config.get("negative_pickle"):
            total.update(load_grid_index(config["negative_pickle"]))
        self.records, self.clz_stats, self.act_stats = build_records(
            total, valid_acts, config.get("track", "RandomEvents"), positive_keys, config.get("task")
        )
        self.positive_records = [r for r in self.records if r.positive]
        self.negative_records = [r for r in self.records if not r.positive]

    def __len__(self):
        return len(self.records)
