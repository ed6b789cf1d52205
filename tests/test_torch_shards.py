"""The port's packed-shard store (kurosiwo_torch.data.shards) against the JAX
package's (kurosiwo_tpu.data.shards): the same bytes written, each reading
the other's pack, and the port's Loader on a pack giving the JAX loader's
batches; a record missing from the pack decodes from its source; the stale
and legacy pack rules; the pack command.

Exactness class (ROADMAP C5): bit-exact (numpy on both sides; float16 packs
are compared as written bytes and as the float32 casts both packages make).
"""

import json

import numpy as np
import pytest

from kurosiwo_torch.data import shards as tshards
from kurosiwo_torch.data.pipeline import Loader as TLoader
from kurosiwo_tpu.data import shards as jshards
from kurosiwo_tpu.data.pipeline import Loader as JLoader


def _cfg(base_config, **kw):
    # 10 samples at batch 4 (train drops 2, val pads 2), 32x32, DEM on
    return {**base_config, "batch_size": 4, "synthetic_size": 10, "synthetic_patch_size": 32,
            "num_workers": 2, "dem": True, **kw}


def _jax_loader(mode, cfg, seed=3):
    return JLoader(mode, cfg, seed, synthetic=True, process_index=0, process_count=1)


def _files(split_dir):
    return sorted(p.name for p in split_dir.iterdir())


def _assert_samples_equal(got, want):
    for k, v in want.__dict__.items():
        g = getattr(got, k)
        if v is None:
            assert g is None, k
        else:
            assert np.asarray(g).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(g, v, err_msg=k)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture
def jax_packs(base_config, tmp_path):
    """Packs written by the JAX package's pack_split from its Loader (numpy
    only, milliseconds): train and val in float32, train in float16, val
    without the DEM."""
    base = base_config
    root = tmp_path / "jax_packs"
    out = {}
    for name, mode, dtype, kw in (("f32", "train", "float32", {}), ("f32", "val", "float32", {}),
                                  ("f16", "train", "float16", {}),
                                  ("nodem", "val", "float32", {"dem": False})):
        cfg = _cfg(base, **kw)
        jshards.pack_split(_jax_loader(mode, cfg), root / name / mode, img_dtype=dtype,
                           records_per_shard=4)
        out[(name, mode)] = (root / name, cfg)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_writer_writes_the_jax_bytes(base_config, jax_packs, tmp_path, dtype):
    name = "f32" if dtype == "float32" else "f16"
    jax_root, cfg = jax_packs[(name, "train")]
    n = tshards.pack_split(TLoader("train", cfg, 3), tmp_path / "train", img_dtype=dtype,
                           records_per_shard=4)
    want_dir, got_dir = jax_root / "train", tmp_path / "train"
    assert n == 10 and _files(got_dir) == _files(want_dir)
    assert _files(got_dir) == ["manifest.json", "shard_00000.bin", "shard_00001.bin",
                               "shard_00002.bin"]
    for f in _files(want_dir):
        assert (got_dir / f).read_bytes() == (want_dir / f).read_bytes(), f


@pytest.mark.parametrize("pack", ["f32", "f16", "nodem"])
def test_port_reads_a_jax_pack_bitwise(jax_packs, pack):
    """Every record of a JAX pack, read by the port's reader, is the JAX
    reader's sample (the float16 images cast to float32 the same way; a pack
    without the DEM reads back dem=None)."""
    mode = "val" if pack == "nodem" else "train"
    jax_root, cfg = jax_packs[(pack, mode)]
    got, want = tshards.ShardReader(jax_root / mode), jshards.ShardReader(jax_root / mode)
    assert len(got) == len(want) == 10 and got.fields == want.fields
    assert ("dem" in got.fields) == (pack != "nodem")
    for rec in TLoader(mode, cfg, 3).records:
        assert rec.id in got
        _assert_samples_equal(got.read(rec.id), want.read(rec.id))
    if pack == "f32":  # a float32 pack holds the decode bit for bit
        loader = TLoader(mode, cfg, 3)
        for rec in loader.records:
            _assert_samples_equal(got.read(rec.id), loader._read(rec))


@pytest.mark.parametrize("pack", ["f32", "f16"])
def test_loader_on_packed_shards_gives_the_jax_batches(jax_packs, pack):
    """The port's Loader and the JAX one on the same pack: every key of
    every batch, over two epochs (train shuffles; val pads)."""
    jax_root, cfg = jax_packs[(pack, "train")]
    packed = dict(cfg, packed_shards=str(jax_root))
    modes = ("train", "val") if pack == "f32" else ("train",)
    for mode in modes:
        got, want = TLoader(mode, packed, 3), _jax_loader(mode, packed)
        assert got.shard_reader is not None and want.shard_reader is not None
        for _ in range(2):
            _assert_batches_equal(list(got), list(want))


def test_record_missing_from_the_pack_falls_through(base_config, tmp_path):
    """A pack of the first 6 records serves a split of 10: the other 4 decode
    from the synthetic source, as in the JAX loader."""
    small = _cfg(base_config, synthetic_size=6)
    tshards.pack_split(TLoader("val", small, 3), tmp_path / "val", img_dtype="float16")
    cfg = _cfg(base_config, packed_shards=str(tmp_path))
    got, want = TLoader("val", cfg, 3), _jax_loader("val", cfg)
    assert len(got.shard_reader) == 6 and len(got.records) == 10
    assert [r.id in got.shard_reader for r in got.records] == [True] * 6 + [False] * 4
    _assert_batches_equal(list(got), list(want))


def test_stale_pack_raises_and_legacy_pack_loads(base_config, tmp_path):
    """A pack written under another decode config raises on both sides; a
    legacy pack (no fingerprint) loads as it is."""
    tshards.pack_split(TLoader("train", _cfg(base_config), 3), tmp_path / "train",
                       img_dtype="float32")
    for kw in ({"clamp_input": 0.3}, {"uint8": True}):
        cfg = _cfg(base_config, packed_shards=str(tmp_path), **kw)
        for make in (lambda c: TLoader("train", c, 3), lambda c: _jax_loader("train", c)):
            with pytest.raises(ValueError, match="decode config"):
                make(cfg)
    assert TLoader("train", _cfg(base_config, packed_shards=str(tmp_path)), 3).shard_reader
    mpath = tmp_path / "train" / "manifest.json"
    m = json.loads(mpath.read_text())
    assert m["decode_config"] == jshards.decode_fingerprint(_cfg(base_config))
    del m["decode_config"]
    mpath.write_text(json.dumps(m))
    legacy = _cfg(base_config, packed_shards=str(tmp_path), clamp_input=0.3)
    assert TLoader("train", legacy, 3).shard_reader is not None


def test_pack_command_packs_each_split(tmp_path):
    """python -m kurosiwo_torch.data.shards on the repository's configs cut
    to 12 samples of 32x32: each split packed, and the port's Loader on the
    float32 pack gives the batches of the decoded source."""
    import pathlib
    import shutil

    from kurosiwo_torch.config import load_config, load_json5

    configs = tmp_path / "configs"
    shutil.copytree(pathlib.Path(__file__).resolve().parent.parent / "configs", configs)
    path = configs / "config.json"
    path.write_text(json.dumps({**load_json5(path), "synthetic_size": 12,
                                "synthetic_patch_size": 32}))
    path = configs / "train" / "train_config.json"
    path.write_text(json.dumps({**load_json5(path), "batch_size": 4, "num_workers": 2}))
    out = tmp_path / "packs"
    packed = tshards.main(["--out", str(out), "--splits", "train", "val", "--dtype", "float32",
                           "--records-per-shard", "5", "--config_root", str(configs)])
    assert packed == {"train": 12, "val": 12}
    assert _files(out / "train") == ["manifest.json", "shard_00000.bin", "shard_00001.bin",
                                     "shard_00002.bin"]
    cfg = load_config(method="unet", config_root=configs)
    got = TLoader("val", dict(cfg, packed_shards=str(out)), 0)
    assert got.shard_reader is not None
    _assert_batches_equal(list(got), list(TLoader("val", cfg, 0)))
