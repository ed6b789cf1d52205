"""Packed-shard sample store; the port's own copy of
``kurosiwo_tpu/data/shards.py``, byte for byte the same layout, so a pack
written by either package is read by the other.

A split is converted once into fixed-record binary shards that the Loader
memory-maps: one ``memmap`` slice per sample in place of about 9 GeoTIFF
opens and decodes, and the OS page cache does the prefetching.

Layout of a packed split directory:

  manifest.json   field table {name: {shape, dtype, offset}},
                  record_nbytes, records_per_shard, img_dtype, shard list,
                  key list, and decode_config (absent on legacy packs)
  shard_00000.bin records_per_shard fixed-size records, concatenated

Keys are ``Record.id`` strings; the manifest maps key -> global row. Images
default to float16 (half the disk and read bandwidth of the f32 decode);
``img_dtype="float32"`` stores them bit-exact.

Pack a split with the port's command::

    python -m kurosiwo_torch.data.shards --out DIR [--splits train val test]
        [--dtype float16|float32] [--records-per-shard 512] [--method unet]

then set ``"packed_shards": "DIR"`` in the config.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .tiles import RawSample

_IMG_FIELDS = ("post", "pre1", "pre2")


def _field_table(sample: RawSample, img_dtype: str) -> tuple[dict, int]:
    """{name: {shape, dtype, offset}} in the record's field order, and the
    record's byte size: the three images, mask and valid (int8), the DEM
    (float32) when the sample has one, then clz and activation (int32)."""
    fields = {}
    offset = 0
    for name in _IMG_FIELDS:
        arr = getattr(sample, name)
        fields[name] = {"shape": list(arr.shape), "dtype": img_dtype, "offset": offset}
        offset += int(np.prod(arr.shape)) * np.dtype(img_dtype).itemsize
    for name, arr in (("mask", sample.mask), ("valid", sample.valid)):
        fields[name] = {"shape": list(arr.shape), "dtype": "int8", "offset": offset}
        offset += int(np.prod(arr.shape))
    if sample.dem is not None:
        fields["dem"] = {"shape": list(sample.dem.shape), "dtype": "float32", "offset": offset}
        offset += int(np.prod(sample.dem.shape)) * 4
    fields["clz"] = {"shape": [], "dtype": "int32", "offset": offset}
    offset += 4
    fields["activation"] = {"shape": [], "dtype": "int32", "offset": offset}
    offset += 4
    return fields, offset


class ShardWriter:
    """Streams RawSamples into fixed-record shards and a manifest."""

    def __init__(self, out_dir: str | os.PathLike, img_dtype: str = "float16",
                 records_per_shard: int = 512, decode_config: dict | None = None):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.img_dtype = img_dtype
        self.records_per_shard = records_per_shard
        self.decode_config = decode_config
        self.fields = None
        self.record_nbytes = 0
        self.keys: list[str] = []
        self._fh = None
        self._shards: list[dict] = []

    def add(self, key: str, sample: RawSample) -> None:
        if self.fields is None:
            self.fields, self.record_nbytes = _field_table(sample, self.img_dtype)
        if len(self.keys) % self.records_per_shard == 0:
            if self._fh:
                self._fh.close()
            name = f"shard_{len(self._shards):05d}.bin"
            self._shards.append({"file": name, "count": 0})
            self._fh = open(self.dir / name, "wb")
        buf = bytearray(self.record_nbytes)
        for name, spec in self.fields.items():
            arr = sample.dem if name == "dem" else getattr(sample, name)
            flat = np.ascontiguousarray(arr, dtype=np.dtype(spec["dtype"])).tobytes()
            buf[spec["offset"]: spec["offset"] + len(flat)] = flat
        self._fh.write(bytes(buf))
        self._shards[-1]["count"] += 1
        self.keys.append(key)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        manifest = {
            "record_nbytes": self.record_nbytes,
            "records_per_shard": self.records_per_shard,
            "img_dtype": self.img_dtype,
            "fields": self.fields,
            "shards": self._shards,
            "keys": self.keys,
        }
        if self.decode_config is not None:
            manifest["decode_config"] = self.decode_config
        with open(self.dir / "manifest.json", "w") as f:
            json.dump(manifest, f)


class ShardReader:
    """Memory-mapped random access to a packed split. Reads are thread-safe
    (numpy memmap slices); a shard is mapped at its first read. Pickles
    without its maps, so a decode worker process maps its own."""

    def __init__(self, split_dir: str | os.PathLike):
        self.dir = Path(split_dir)
        with open(self.dir / "manifest.json") as f:
            m = json.load(f)
        self.fields = m["fields"]
        self.record_nbytes = m["record_nbytes"]
        self.per_shard = m["records_per_shard"]
        self.shards = m["shards"]
        self.decode_config = m.get("decode_config")  # None on legacy packs
        self.rows = {k: i for i, k in enumerate(m["keys"])}
        self._maps: dict[int, np.memmap] = {}

    def __getstate__(self) -> dict:
        return dict(self.__dict__, _maps={})

    def check_decode_config(self, config: dict) -> None:
        """Raise if this pack was written under another decode config: its
        bytes bake in the channels, clamping, uint8 quantization and the
        DEM's standardization, and a clamp or uint8 change does not even
        fail on shape. Legacy packs without a fingerprint are accepted."""
        if self.decode_config is None:
            return
        want = decode_fingerprint(config)
        if want != self.decode_config:
            diff = {
                k: (self.decode_config.get(k), want.get(k))
                for k in set(want) | set(self.decode_config)
                if self.decode_config.get(k) != want.get(k)
            }
            raise ValueError(
                f"packed shards at {self.dir} were written under a different "
                f"decode config (packed vs current): {diff}; re-pack the split "
                "or align the config"
            )

    def __contains__(self, key: str) -> bool:
        return key in self.rows

    def __len__(self) -> int:
        return len(self.rows)

    def _map(self, shard_idx: int) -> np.memmap:
        mm = self._maps.get(shard_idx)
        if mm is None:
            spec = self.shards[shard_idx]
            mm = np.memmap(self.dir / spec["file"], dtype=np.uint8, mode="r",
                           shape=(spec["count"] * self.record_nbytes,))
            self._maps[shard_idx] = mm
        return mm

    def read(self, key: str) -> RawSample:
        row = self.rows[key]
        mm = self._map(row // self.per_shard)
        base = (row % self.per_shard) * self.record_nbytes

        def field(name, cast=None):
            spec = self.fields.get(name)
            if spec is None:
                return None
            dt = np.dtype(spec["dtype"])
            n = int(np.prod(spec["shape"])) if spec["shape"] else 1
            # a view of the map: the cast (or copy) below is the one pass
            # over the bytes
            arr = np.frombuffer(mm, dtype=dt, count=n, offset=base + spec["offset"])
            arr = arr.reshape(spec["shape"]) if spec["shape"] else arr[0]
            if cast is not None:
                return arr.astype(cast)
            # the view is read-only: copy, so later steps may write in place
            return arr.copy() if isinstance(arr, np.ndarray) else arr

        return RawSample(
            post=field("post", np.float32),
            pre1=field("pre1", np.float32),
            pre2=field("pre2", np.float32),
            mask=field("mask", np.int32),
            valid=field("valid", np.int32),
            dem=field("dem"),
            clz=int(field("clz")),
            activation=int(field("activation")),
        )


def decode_fingerprint(config: dict) -> dict:
    """The config keys that change what a decoded RawSample contains (not
    how the step normalizes it): a pack made under one fingerprint serves
    wrong data under another."""
    fp = {
        "channels": list(config.get("channels", [])),
        "clamp_input": config.get("clamp_input"),
        "uint8": bool(config.get("uint8")),
        "dem": bool(config.get("dem")),
        "slope": bool(config.get("slope")),
        "slc": bool(config.get("slc")),
        # read_dem standardizes on the host iff scale_input is set
        "dem_standardized": config.get("scale_input") is not None,
    }
    if fp["dem"] and fp["dem_standardized"]:
        for k in ("dem_mean", "dem_std", "slope_mean", "slope_std"):
            if k in config:
                fp[k] = config[k]
    return fp


def pack_split(loader, out_dir: str | os.PathLike, img_dtype: str = "float16",
               records_per_shard: int = 512, workers: int = 8) -> int:
    """Pack every record a Loader can decode into ``out_dir``; returns the
    number of packed samples. Decodes run on a thread pool (``loader._read``,
    the tile or synthetic decode) while one writer appends in record order,
    so the layout is that of a serial pack."""
    w = ShardWriter(out_dir, img_dtype=img_dtype, records_per_shard=records_per_shard,
                    decode_config=decode_fingerprint(loader.config))
    if workers <= 1:
        for rec in loader.records:
            w.add(rec.id, loader._read(rec))
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            chunk = 1024  # bounds the pending results on a large corpus
            for i in range(0, len(loader.records), chunk):
                block = loader.records[i: i + chunk]
                for rec, sample in zip(block, pool.map(loader._read, block)):
                    w.add(rec.id, sample)
    w.close()
    return len(w.keys)


def main(argv=None) -> dict:
    """The pack command: each split of the port's ``load_config(method=...)``
    decoded from its source (never from an earlier pack) into
    ``<out>/<split>``. Returns {split: samples packed}."""
    p = argparse.ArgumentParser(prog="python -m kurosiwo_torch.data.shards")
    p.add_argument("--out", required=True)
    p.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    p.add_argument("--dtype", default="float16", choices=["float16", "float32"])
    p.add_argument("--records-per-shard", type=int, default=512)
    p.add_argument("--method", default="unet")
    p.add_argument("--config_root", default="configs")
    args = p.parse_args(argv)

    from ..config import load_config
    from .pipeline import Loader

    cfg = load_config(method=args.method, config_root=args.config_root)
    cfg.pop("packed_shards", None)
    packed = {}
    for split in args.splits:
        t0 = time.time()
        loader = Loader(split, cfg, seed=0)
        packed[split] = pack_split(loader, os.path.join(args.out, split), img_dtype=args.dtype,
                                   records_per_shard=args.records_per_shard,
                                   workers=loader.workers)
        print(f"{split}: packed {packed[split]} samples in {time.time() - t0:.1f}s", flush=True)
    return packed


if __name__ == "__main__":
    main()
