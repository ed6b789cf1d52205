"""The port's SLC loader (kurosiwo_torch/data/slc.py) against the JAX
package's ``SLCLoader``: cv2-written 4-band rasters (imwritemulti), uint8
label and valid masks, a float32 DEM with the SLC nodata sentinel, and one
200x200 grid that both pad centred to 224 with the int-truncated flood mean
(mask 3). Batches are compared bitwise: train (two epochs) and val with the
normalized config, train with the uint8 and DEM/slope configs, every split
of the synthetic source; the
helpers (``read_multiband``, ``pad_to``, ``load_slc_records``,
``_maybe_uint8``) against JAX's."""

import json

import numpy as np
import pytest

from kurosiwo_torch.data import pipeline as tpipe
from kurosiwo_torch.data import slc as tslc
from kurosiwo_tpu.data import slc as jslc

cv2 = pytest.importorskip("cv2")

SIZES = [(130, 224), (130, 224), (470, 200), (130, 224), (514, 224), (514, 200)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("slc")
    rs = np.random.RandomState(0)
    index = {}
    for i, (act, size) in enumerate(SIZES):
        gdir = root / str(act) / "01" / f"g{i:04d}"
        gdir.mkdir(parents=True)
        for prefix in ("MS1", "SL1", "SL2"):
            bands = [(rs.rand(size, size) * 40).astype(np.float32) for _ in range(4)]
            assert cv2.imwritemulti(str(gdir / f"{prefix}_slc.tif"), bands)
        cv2.imwrite(str(gdir / "MK0_MLU_mask.tif"), rs.randint(0, 4, (size, size)).astype(np.uint8))
        cv2.imwrite(str(gdir / "MK0_MNA_valid.tif"), (rs.rand(size, size) > 0.1).astype(np.uint8))
        dem = (rs.randn(size, size) * 50 + 80).astype(np.float32)
        dem[:2, :5] = 3.4e38  # the SLC nodata sentinel
        cv2.imwrite(str(gdir / "MK0_DEM_dem.tif"), dem)
        index[f"g{i:04d}"] = {"actid": act, "path": f"{act}/01/g{i:04d}", "aoiid": 1,
                              "clz": 1 + i % 3}
    jpath = root / "slc_index.json"
    jpath.write_text(json.dumps(index))
    return root, jpath


def _cfg(root, jpath, **kw):
    cfg = {
        "slc": True, "slc_root_path": str(root), "track": "RandomEvents",
        "train_json": str(jpath), "test_json": str(jpath), "batch_size": 2, "num_workers": 2,
        "channels": ["vv", "vh"], "scale_input": "normalize",
        "slc_mean": [2.2367e-02, 3.9242e01, 8.1130e01, 4.3526e-02],
        "slc_std": [1.2843, 25.6152, 58.0151, 1.2844],
        "slc_dem_mean": 82.96, "slc_dem_std": 153.71,
        "slc_slope_mean": 0.3977, "slc_slope_std": 0.4946,
        "dem": False, "slope": False, "uint8": False, "task": "segmentation",
        "synthetic_data": False, "oversampling": False, "train_acts": [130, 470],
        "val_acts": [514], "test_acts": [514], "clamp_input": 0.15,
        "synthetic_patch_size": 32,
    }
    cfg.update(kw)
    return cfg


def _assert_equal(got: list, want: list):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k], equal_nan=True), k


@pytest.mark.parametrize("kw", [
    {},
    {"uint8": True, "scale_input": None},
    {"dem": True},
    {"dem": True, "slope": True},
], ids=["normalize", "uint8", "dem", "slope"])
def test_slc_batches_bitwise_jax(corpus, kw):
    """Train (two epochs) and val (its padded last batch) with the
    normalized config; train with the others."""
    root, jpath = corpus
    cfg = _cfg(root, jpath, num_workers=1, **kw)
    for mode in ("train", "val") if not kw else ("train",):
        got = tslc.SLCLoader(mode, cfg, seed=4)
        want = jslc.SLCLoader(mode, cfg, seed=4)
        assert not got.synthetic and [r.id for r in got.records] == [r.id for r in want.records]
        try:
            for _ in range(2 if mode == "train" and not kw else 1):
                _assert_equal(list(got), list(want))
        finally:
            got.close()


def test_ragged_tile_is_padded_centred_as_jax(corpus):
    root, jpath = corpus
    cfg = _cfg(root, jpath)
    got, want = tslc.SLCLoader("train", cfg, seed=1), jslc.SLCLoader("train", cfg, seed=1)
    ragged = [r for r in got.records if r.activation == 470][0]
    g, w = got.decoder.read(ragged), want._read(ragged)
    assert g.post.shape == (224, 224, 4) and (g.mask == 3).sum() >= 224 * 224 - 200 * 200
    for name in ("post", "pre1", "pre2", "mask", "valid"):
        assert np.array_equal(getattr(g, name), getattr(w, name)), name


def test_synthetic_slc_loaders_bitwise_jax(corpus):
    root, jpath = corpus
    cfg = _cfg(root, jpath, synthetic_data=True, synthetic_size=6, batch_size=4)
    for mode in ("train", "val", "test"):
        got, want = tslc.SLCLoader(mode, cfg, seed=2), jslc.SLCLoader(mode, cfg, seed=2)
        assert got.synthetic and want.synthetic
        try:
            _assert_equal(list(got), list(want))
        finally:
            got.close()


def test_prepare_loaders_gives_slc_loaders(corpus):
    root, jpath = corpus
    loaders = tpipe.prepare_loaders(_cfg(root, jpath), seed=3)
    assert [type(x) for x in loaders] == [tslc.SLCLoader] * 3
    assert [x.mode for x in loaders] == ["train", "val", "test"]
    for x in loaders:
        x.close()


def test_read_multiband_and_pad_to_equal_jax(corpus):
    root, _ = corpus
    for p in sorted(root.rglob("MS1_slc.tif")):
        g, w = tslc.read_multiband(str(p)), jslc.read_multiband(str(p))
        assert g.shape[-1] == 4 and g.dtype == np.float32 and np.array_equal(g, w)
    img = np.arange(7 * 5 * 2, dtype=np.float32).reshape(7, 5, 2)
    for size, value in ((10, 3.0), (7, 0.0), (4, 1.0)):
        assert np.array_equal(tslc.pad_to(img, size, value), jslc.pad_to(img, size, value))


@pytest.mark.parametrize("track", ["RandomEvents", "Climatic"])
def test_load_slc_records_equal_jax(tmp_path, track):
    grids = [{"actid": 130, "path": "a", "aoiid": 1}, {"actid": 470, "path": "b", "clz": 2},
             {"actid": 130, "path": "c", "aoiid": 3, "clz": 3}]
    listed, keyed = tmp_path / "list.json", tmp_path / "dict.json"
    listed.write_text(json.dumps(grids))
    keyed.write_text(json.dumps({f"k{i}": g for i, g in enumerate(grids)}))
    acts = [130, 470] if track == "RandomEvents" else ["130_01", "470_00"]
    for path in (listed, keyed):
        got = tslc.load_slc_records(str(path), acts, track)
        want = jslc.load_slc_records(str(path), acts, track)
        assert [vars(r) for r in got] == [vars(r) for r in want] and got


def test_maybe_uint8_equal_jax():
    rs = np.random.RandomState(3)
    img = (rs.randn(16, 16, 4) * 100).astype(np.float32)
    img[0, :3] = np.nan
    for cfg in ({"uint8": True}, {"uint8": False}):
        assert np.array_equal(tslc._maybe_uint8(img, cfg), jslc._maybe_uint8(img, cfg),
                              equal_nan=True)
    nan = np.full((4, 4), np.nan, np.float32)
    assert np.array_equal(tslc._maybe_uint8(nan, {"uint8": True}),
                          jslc._maybe_uint8(nan, {"uint8": True}))
