"""Synthetic SAR sample source — deterministic stand-in for the Kuro Siwo
tiles when the corpus is not on disk (tests, benches, dry runs). The port's
own copy of ``kurosiwo_tpu/data/synthetic.py``: the same numpy draws, so a
sample is bitwise the JAX package's.

Shapes/dtypes/semantics mirror RawSample from tiles.py: 224x224 VV/VH
acquisitions (values in [0, clamp] like calibrated backscatter), 4-class mask
with invalid=3 border regions, valid-pixel mask, optional DEM channel.
Per-index determinism: sample i is a pure function of (seed, i).
"""

from __future__ import annotations

import numpy as np

from .index import Record
from .tiles import RawSample

CLIMATE_ZONES = (1, 2, 3)


def synthetic_records(n: int, acts: list, seed: int = 0) -> list[Record]:
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        act = acts[i % len(acts)] if acts else 130
        recs.append(
            Record(
                id=f"synthetic{i:08x}",
                path=f"synthetic/{act}/{i:08x}",
                clz=int(CLIMATE_ZONES[i % len(CLIMATE_ZONES)]),
                activation=act,
                aoi=i % 4,
                positive=(i % 2 == 0),
            )
        )
    return recs


def synthetic_raw_sample(record: Record, config: dict, size: int = 224, seed: int = 1234) -> RawSample:
    idx = int(record.id[-8:], 16)
    rng = np.random.RandomState((seed * 1_000_003 + idx) % (2**31 - 1))
    clamp = config.get("clamp_input", 0.15) or 0.15
    nch = len(config["channels"])

    def acq():
        base = rng.gamma(2.0, clamp / 6.0, size=(size, size, nch)).astype(np.float32)
        return np.clip(base, 0.0, clamp)

    post, pre1, pre2 = acq(), acq(), acq()
    # blobby mask: water bodies + flood region around them
    yy, xx = np.mgrid[0:size, 0:size]
    mask = np.zeros((size, size), np.int32)
    for _ in range(3):
        cy, cx, r = rng.randint(0, size), rng.randint(0, size), rng.randint(8, 40)
        mask[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1
    if record.positive:
        for _ in range(2):
            cy, cx, r = rng.randint(0, size), rng.randint(0, size), rng.randint(10, 50)
            mask[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 2
    valid = np.ones((size, size), np.int32)
    border = rng.randint(0, 12)
    if border:
        valid[:border] = 0
        mask[:border] = 3
    dem = None
    if config.get("dem"):
        dem = rng.randn(size, size, 1).astype(np.float32)
    return RawSample(post, pre1, pre2, mask, valid, dem, record.clz, int(record.activation))
