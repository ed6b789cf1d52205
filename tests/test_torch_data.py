"""The port's data layer (kurosiwo_torch.data) against the JAX package's
(kurosiwo_tpu.data): the Loader's batches for the same config and seed,
every key of every batch, in every split, over two epochs.

Exactness class (ROADMAP C5): bit-exact (numpy on both sides).
"""

import numpy as np
import pytest

from kurosiwo_torch.data import pipeline as tpipe
from kurosiwo_torch.data import synthetic as tsyn
from kurosiwo_tpu.data import pipeline as jpipe
from kurosiwo_tpu.data import synthetic as jsyn


def _cfg(base_config, **kw):
    # 10 samples at batch 4: train drops 2 (drop_last), val/test pad 2
    return dict(base_config, batch_size=4, synthetic_size=10, synthetic_patch_size=32,
                num_workers=2, **kw)


def _epochs(loader, n=2):
    return [list(loader) for _ in range(n)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


CASES = {
    "default": {},
    "oversampling": {"oversampling": True},
    "dem": {"dem": True},
    "unscaled-post-only": {"scale_input": None, "inputs": ["post_event"]},
}


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("kw", CASES.values(), ids=CASES.keys())
def test_loader_batches_are_the_jax_loaders(base_config, mode, kw):
    cfg = _cfg(base_config, **kw)
    got_loader = tpipe.Loader(mode, cfg, seed=5)
    want_loader = jpipe.Loader(mode, cfg, seed=5, process_index=0, process_count=1)
    assert len(got_loader) == len(want_loader) == (2 if mode == "train" else 3)
    got, want = _epochs(got_loader), _epochs(want_loader)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    if mode == "train":  # a new shuffle each epoch
        assert not np.array_equal(got[0][0]["post"], got[1][0]["post"])
    else:  # the last batch pads 2 inert samples
        last = got[0][-1]
        np.testing.assert_array_equal(last["sample_weight"], [1, 1, 0, 0])
        assert (last["mask"][2:] == 3).all()


def test_prepare_loaders_matches_jax(base_config):
    cfg = _cfg(base_config)
    got = tpipe.prepare_loaders(cfg, seed=9)
    want = [jpipe.Loader(m, cfg, seed=9, process_index=0, process_count=1)
            for m in ("train", "val", "test")]
    for g, w in zip(got, want):
        assert g.mode == w.mode and g.num_samples() == w.num_samples()
        _assert_batches_equal(list(g), list(w))


def test_synthetic_source_matches_jax(base_config):
    cfg = dict(base_config, dem=True)
    for rec_t, rec_j in zip(tsyn.synthetic_records(6, [130, 470], 3),
                            jsyn.synthetic_records(6, [130, 470], 3)):
        assert rec_t.__dict__ == rec_j.__dict__
        got = tsyn.synthetic_raw_sample(rec_t, cfg, size=24, seed=3)
        want = jsyn.synthetic_raw_sample(rec_j, cfg, size=24, seed=3)
        for k, v in want.__dict__.items():
            np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)


def test_epoch_rng_and_process_grid_match_jax(base_config):
    for mode in ("train", "val", "test"):
        np.testing.assert_array_equal(tpipe.epoch_rng(7, mode).integers(0, 1 << 30, 8),
                                      jpipe.epoch_rng(7, mode).integers(0, 1 << 30, 8))
    # the port decodes the whole global batch: JAX's grid at process 0 of 1
    cfg = _cfg(base_config)
    _, _, local = jpipe.resolve_process_grid(cfg["batch_size"], 0, 1)
    assert next(iter(tpipe.Loader("val", cfg)))["post"].shape[0] == local


def test_loader_rejects_stats_modes_on_synthetic_data(base_config):
    with pytest.raises(ValueError, match="synthetic"):
        tpipe.Loader("train", _cfg(base_config, scale_input="min-max"))


def test_abandoned_epoch_stops_the_feeder(base_config):
    it = iter(tpipe.Loader("val", _cfg(base_config)))
    next(it)
    it.close()  # the feeder thread ends instead of blocking on a full queue


@pytest.mark.parametrize("kw,what", [
    ({"packed_shards": "shards/"}, None),
    ({"slc": True, "slc_mean": [2.2367e-02, 3.9242e01, 8.1130e01, 4.3526e-02],
      "slc_std": [1.2843, 25.6152, 58.0151, 1.2844]}, "SLC"),
], ids=["shards", "slc"])
def test_unported_sources_name_a14(base_config, kw, what):
    """A14's sources are ported: packed_shards (a split with no pack under
    the directory decodes from its source, as JAX's does) and the SLC
    loader (``slc: true``: the three SLCLoaders, their synthetic batches
    bitwise the JAX package's)."""
    got = tpipe.prepare_loaders(_cfg(base_config, **kw), seed=9)
    if what is None:
        want = [jpipe.Loader(m, _cfg(base_config, **kw), seed=9, process_index=0,
                             process_count=1) for m in ("train", "val", "test")]
        for g, w in zip(got, want):
            assert g.shard_reader is None and w.shard_reader is None
    else:
        want = jpipe.prepare_loaders(_cfg(base_config, **kw), seed=9)
        assert [type(g).__name__ for g in got] == ["SLCLoader"] * 3
    for g, w in zip(got, want):
        _assert_batches_equal(list(g), list(w))
        g.close()


def test_diffusion_loader_names_a10(base_config):
    """The diffusion task's per-observation loader (A10, ported): three
    typed records a patch, batches of ``image`` bitwise the JAX loader's
    (``tests/test_torch_diffusion_train.py`` holds every split and a pack)."""
    cfg = _cfg(base_config, task="diffusion-unsup")
    got = tpipe.Loader("train", cfg, seed=5)
    want = jpipe.Loader("train", cfg, seed=5, process_index=0, process_count=1)
    assert len(got) == len(want) == 7  # 30 typed records at batch 4
    _assert_batches_equal(list(got), list(want))
    assert {r.type for r in got.records} == {"pre1", "pre2", "flood"}


def test_tile_decode_without_cv2_says_so(monkeypatch, tmp_path):
    import builtins

    from kurosiwo_torch.data import tiles

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="needs cv2"):
        tiles._imread(str(tmp_path / "MK0_MLU.tif"))


def _write_corpus(root, rs, acts=(130, 470, 514), per_act=3, size=16):
    """A tiny Kuro Siwo layout: gzip-pickled grid indices and one directory
    of GeoTIFF tiles (float32 backscatter with NaNs, uint8 label and valid
    masks, a float32 DEM) per grid, written with cv2."""
    import gzip
    import pickle

    import cv2

    grids = {}
    for a in acts:
        for i in range(per_act):
            key = f"{a:04x}{i:04x}"
            rel = f"{a}/{key}"
            gdir = root / "data" / rel
            gdir.mkdir(parents=True)
            for prefix in ("MS1_IVV", "MS1_IVH", "SL1_IVV", "SL1_IVH", "SL2_IVV", "SL2_IVH"):
                img = rs.gamma(2.0, 0.03, (size, size)).astype(np.float32)
                img[rs.rand(size, size) < 0.05] = np.nan
                cv2.imwrite(str(gdir / f"{prefix}_{key}.tif"), img)
            cv2.imwrite(str(gdir / f"MK0_MLU_{key}.tif"),
                        rs.randint(0, 4, (size, size)).astype(np.uint8))
            cv2.imwrite(str(gdir / f"MK0_MNA_{key}.tif"),
                        (rs.rand(size, size) > 0.1).astype(np.uint8))
            dem = (rs.randn(size, size) * 100).astype(np.float32)
            dem[0, :3] = np.nan
            cv2.imwrite(str(gdir / f"MK0_DEM_{key}.tif"), dem)
            grids[key] = {"path": rel, "info": {"actid": a, "aoiid": i}, "clz": 1 + i % 3}
    (root / "pickle").mkdir()
    for name in ("train.gz", "test.gz"):
        with gzip.open(root / "pickle" / name, "wb") as f:
            pickle.dump(grids, f)


@pytest.mark.parametrize("kw", [
    {"scale_input": "normalize", "dem": True},
    {"scale_input": "min-max"},
    {"scale_input": "custom", "channels": ["vv", "vh", "vh/vv"], "dem": True, "slope": True},
    {"scale_input": None, "uint8": True},
], ids=["normalize-dem", "min-max", "custom-ratio-slope", "uint8"])
def test_loader_reads_a_corpus_as_the_jax_loader(base_config, tmp_path, monkeypatch, kw):
    """The tile decode, scaling and index readers on a corpus on disk (JAX's
    native libtiff decoder off: both packages decode with cv2)."""
    from kurosiwo_tpu.data import tiles as jtiles

    monkeypatch.setattr(jtiles, "_USE_NATIVE", False)
    monkeypatch.chdir(tmp_path)  # the min-max stats cache, stats.pkl
    _write_corpus(tmp_path, np.random.RandomState(0))
    cfg = dict(base_config, root_path=str(tmp_path), synthetic_data=False, batch_size=2,
               num_workers=2, train_pickle=str(tmp_path / "pickle/train.gz"),
               test_pickle=str(tmp_path / "pickle/test.gz"), train_acts=[130, 470],
               val_acts=[514], test_acts=[514], **kw)
    for mode in ("train", "val"):
        got = tpipe.Loader(mode, cfg, seed=2)
        want = jpipe.Loader(mode, cfg, seed=2, process_index=0, process_count=1)
        assert not got.synthetic and got.num_samples() == want.num_samples() > 0
        _assert_batches_equal(list(got), list(want))
