"""The port's last host paths against the JAX package's:
  * the wandb sink (kurosiwo_torch/utils/logging.py) under a stub ``wandb``
    module in ``sys.modules``: both packages' loggers start the same run
    (``id.json``, ``resume_wandb``), log the same keys and values, and
    ``log_watch`` writes the JAX package's flax-path keys, each histogram
    the converted leaf and each gradient norm the flax leaf's; the engine
    sends its images to wandb; only rank 0 starts a run;
  * ``utils/profiling.py``: ``model_stats``, ``count_params`` and
    ``param_bytes`` equal to JAX's on the same UNet weights, ``StepTimer``,
    ``trace``;
  * the native tile decoder (kurosiwo_torch/data/native.py, built into
    kurosiwo_torch/_build/) bitwise cv2 on float32, uint8 and uint16 tiles
    and bitwise JAX's ``native.decode_tile``; ``tiles._imread``'s choice
    (``KUROSIWO_NATIVE_DECODE=0``, cv2 for a file it refuses) and the
    Loader's start-up line. These skip only where g++ or libtiff is absent.
"""

import json
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.data import native as tnative
from kurosiwo_torch.data import tiles as ttiles
from kurosiwo_torch.models.factory import initialize_segmentation_model as t_init_model
from kurosiwo_torch.utils import logging as tlog
from kurosiwo_torch.utils import profiling as tprof
from kurosiwo_tpu.utils import logging as jlog
from kurosiwo_tpu.utils import profiling as jprof

cv2 = pytest.importorskip("cv2")

CFG = {"task": "segmentation", "method": "unet", "num_classes": 3, "num_channels": 2,
       "inputs": ["post_event"], "channels": ["vv", "vh"], "mixed_precision": False}
MCFG = {"backbone": "resnet18"}


class _Histogram:
    def __init__(self, values):
        self.values = np.asarray(values)


class _Image:
    def __init__(self, img, caption=None):
        self.img, self.caption = np.asarray(img), caption


def _stub_wandb(calls: list) -> types.ModuleType:
    stub = types.ModuleType("wandb")
    stub.util = types.SimpleNamespace(generate_id=lambda: "id-0042")
    stub.init = lambda **kw: calls.append(("init", kw))
    stub.log = lambda payload: calls.append(("log", payload))
    stub.Histogram, stub.Image = _Histogram, _Image
    return stub


@pytest.fixture(scope="module")
def unet():
    model = t_init_model(CFG, MCFG, device="cpu")
    flax = torch_to_flax(model.state_dict())
    return model, flax


def _summary():
    rs = np.random.RandomState(0)
    return {"val_loss": 0.25, "mean_iou": 0.5, "accuracy": rs.rand(3), "fscore": rs.rand(3),
            "precision": rs.rand(3), "recall": rs.rand(3), "iou": rs.rand(3),
            "water_fscore": rs.rand(3), "epoch_time_s": 1.5,
            "zones": [{"mean_iou": 0.1}, {"mean_iou": 0.2}]}


@pytest.mark.parametrize("resume", [False, True], ids=["new run", "resume_wandb"])
def test_wandb_sink_equals_jax_under_a_stub(monkeypatch, tmp_path, capsys, resume):
    """The same init arguments, id.json and logged payloads from both
    packages' loggers (metrics, train iterations and epochs, evals with
    zones and AOIs), to wandb and, with on_screen_prints, to stdout."""
    runs = {}
    for tag, mod in (("jax", jlog), ("torch", tlog)):
        calls = []
        monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls))
        ckpt = tmp_path / tag
        if resume:
            ckpt.mkdir()
            (ckpt / "id.json").write_text(json.dumps({"run_id": "kept-7"}))
        cfg = {"wandb_activate": True, "wandb_project": "p", "wandb_entity": "e",
               "resume_wandb": resume, "checkpoint_path": str(ckpt), "on_screen_prints": True,
               "evaluate_water": True, "log_zone_metrics": True, "batch_size": 8, "lr": 1e-3,
               "nested": {"not": "logged"}}
        logger = mod.MetricLogger(cfg)
        s = _summary()
        logger.log_train_iteration(1, 10, 0.5, 1e-3, snap=s, grad_norm=2.0)
        logger.log_train_epoch(1, s)
        logger.log_eval("Val", s, {130: {"mean_iou": 0.3}})
        init = calls[0][1]
        init["config"].pop("checkpoint_path")
        runs[tag] = (calls[1:], init, json.loads((ckpt / "id.json").read_text()),
                     capsys.readouterr().out)
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][2] == {"run_id": "kept-7" if resume else "id-0042"}
    assert runs["torch"][1]["id"] == runs["torch"][2]["run_id"]


def test_log_watch_writes_jax_keys_and_converted_leaves(monkeypatch, unet):
    """Histograms: JAX's keys over the flax params tree, each value the
    flax leaf (the port's parameter in flax's layout); gradient norms
    under the same keys, equal to the flax leaves' norms."""
    model, flax = unet
    rs = np.random.RandomState(1)
    names = [n for n, _ in model.named_parameters()]
    grads = {n: torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
             for n, p in model.named_parameters()}
    flax_grads = torch_to_flax(grads)["params"]
    payloads = {}
    for tag in ("jax", "torch"):
        calls = []
        monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls))
        logger = (jlog if tag == "jax" else tlog).MetricLogger({"wandb_activate": True})
        if tag == "jax":
            norms = jax.tree.map(lambda g: jnp.sqrt(jnp.sum(jnp.square(jnp.asarray(g)))),
                                 flax_grads)
            logger.log_watch(flax["params"], norms)
        else:
            logger.log_watch(model, {n: torch.linalg.vector_norm(grads[n]) for n in names})
        payloads[tag] = calls[-1][1]
    got, want = payloads["torch"], payloads["jax"]
    assert sorted(got) == sorted(want)
    hist = [k for k in want if k.startswith("parameters/")]
    assert len(hist) == len(names) and "parameters/encoder/stem/Conv_0/kernel" in hist
    for k in hist:
        assert np.array_equal(got[k].values, want[k].values), k
    # f32 sums of up to 2.4 M squares, in XLA's order and in torch's
    for k in want:
        if k.startswith("gradients/"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), k


def test_only_rank_0_starts_a_run_and_engine_images_go_to_wandb(monkeypatch, tmp_path):
    from kurosiwo_torch.training.engine import TaskEngine

    calls = []
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls))
    cfg = dict(CFG, wandb_activate=True, checkpoint_path=str(tmp_path), batch_size=2,
               learning_rate=1e-3, scale_input=None)
    assert tlog.MetricLogger(cfg, main=False).wandb is None and calls == []
    engine = TaskEngine(t_init_model(cfg, MCFG, device="cpu"), cfg, MCFG, "segmentation", 1,
                        device="cpu")
    rs = np.random.RandomState(2)
    batch = {"post": rs.rand(2, 16, 16, 2).astype(np.float32),
             "mask": rs.randint(0, 4, (2, 16, 16)).astype(np.int32)}
    engine._save_visualization(batch, torch.from_numpy(rs.randint(0, 3, (2, 16, 16))), "Val")
    kind, payload = calls[-1]
    assert kind == "log"
    assert sorted(payload) == ["Val ground_truth", "Val image", "Val prediction"]
    assert all(isinstance(v, _Image) for v in payload.values())
    assert not (tmp_path / "viz").exists()


def test_model_stats_equal_jax(unet):
    model, flax = unet
    want = jprof.model_stats(flax["params"], flax["batch_stats"])
    got = tprof.model_stats(model)
    for k in ("num_params", "param_bytes", "num_batch_stats"):
        assert got[k] == want[k], k
    assert tprof.count_params(model) == jprof.count_params(flax["params"])
    assert tprof.param_bytes(model) == jprof.param_bytes(flax["params"])


def test_step_timer_and_trace(tmp_path):
    timer = tprof.StepTimer(batch_size=8, num_chips=2, window=2)
    for _ in range(3):
        timer.start()
        timer.stop(torch.ones(3))
    s = timer.summary()
    assert s["steps_measured"] == 2 and s["mean_step_time_s"] > 0
    assert s["patches_per_sec_per_chip"] == pytest.approx(8 / s["mean_step_time_s"] / 2)
    with tprof.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native tile decoder cannot be built")
    if not tnative.available():
        pytest.skip(f"the native tile decoder is unavailable: {tnative.status()} "
                    "(libtiff.so.6/.so.5 missing?)")
    return tnative.library_path()


def _tiles(tmp_path) -> dict:
    rs = np.random.RandomState(0)
    arrays = {"f32": (rs.rand(96, 128) * 0.2).astype(np.float32),
              "u8": rs.randint(0, 4, (96, 128)).astype(np.uint8),
              "u16": rs.randint(0, 5000, (96, 128)).astype(np.uint16)}
    arrays["f32"][3, :7] = np.nan
    out = {}
    for name, arr in arrays.items():
        p = str(tmp_path / f"{name}.tif")
        assert cv2.imwrite(p, arr)
        out[name] = p
    return out


@pytest.mark.parametrize("kind", ["f32", "u8", "u16"])
def test_native_decode_bitwise_cv2_and_jax(built, tmp_path, kind):
    from kurosiwo_tpu.data import native as jnative

    p = _tiles(tmp_path)[kind]
    got = tnative.decode_tile(p)
    ref = cv2.imread(p, cv2.IMREAD_ANYDEPTH)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref.astype(np.float32), equal_nan=True)
    if jnative.available():
        assert np.array_equal(got, jnative.decode_tile(p), equal_nan=True)
    batch = tnative.decode_batch([p] * 3, tile_pixels=96 * 128)
    assert all(np.array_equal(b, got, equal_nan=True) for b in batch)


def test_native_build_lives_under_the_port(built):
    assert built.parent.parent.name == "_build" and built.parent.parent.parent.name == \
        "kurosiwo_torch" and built.is_file()


def test_imread_choice(built, tmp_path, monkeypatch):
    """Native where it loads (float32 out), cv2 with KUROSIWO_NATIVE_DECODE=0
    (the tile's own dtype) and for a file the native decoder refuses (a PNG);
    the choice is named."""
    p = _tiles(tmp_path)["u8"]
    monkeypatch.setattr(ttiles, "_USE_NATIVE", None)
    assert ttiles._imread(p).dtype == np.float32
    assert ttiles.decoder_choice().startswith("native libtiff")
    png = str(tmp_path / "x.png")
    cv2.imwrite(png, np.full((5, 6), 7, np.uint8))
    assert ttiles._imread(png).dtype == np.uint8  # native raised IOError: cv2
    monkeypatch.setattr(ttiles, "_USE_NATIVE", None)
    monkeypatch.setenv("KUROSIWO_NATIVE_DECODE", "0")
    assert ttiles._imread(p).dtype == np.uint8
    assert ttiles.decoder_choice() == "cv2 (KUROSIWO_NATIVE_DECODE=0)"
    monkeypatch.setattr(ttiles, "_USE_NATIVE", None)


def test_loader_names_its_decoder(built, tmp_path, capsys, monkeypatch):
    """A loader that reads tiles prints its decoder once, at its start."""
    import gzip
    import pickle

    from kurosiwo_torch.data.pipeline import Loader

    monkeypatch.setattr(ttiles, "_USE_NATIVE", None)
    rs = np.random.RandomState(4)
    grids = {}
    for i in range(2):
        gdir = tmp_path / "data" / "130" / f"g{i}"
        gdir.mkdir(parents=True)
        for prefix in ("MS1_IVV", "MS1_IVH", "SL1_IVV", "SL1_IVH", "SL2_IVV", "SL2_IVH"):
            cv2.imwrite(str(gdir / f"{prefix}.tif"), rs.rand(8, 8).astype(np.float32))
        grids[f"g{i}"] = {"path": f"130/g{i}", "info": {"actid": 130, "aoiid": 1}, "clz": 1}
    (tmp_path / "p").mkdir()
    with gzip.open(tmp_path / "p" / "t.gz", "wb") as f:
        pickle.dump(grids, f)
    cfg = {"root_path": str(tmp_path), "train_pickle": str(tmp_path / "p" / "t.gz"),
           "test_pickle": str(tmp_path / "p" / "t.gz"), "train_acts": [130], "batch_size": 2,
           "num_workers": 1, "channels": ["vv", "vh"], "clamp_input": 0.15, "scale_input": None,
           "task": "segmentation", "track": "RandomEvents"}
    loader = Loader("train", cfg, seed=0)
    try:
        list(loader)
        list(loader)
    finally:
        loader.close()
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("Loader train")]
    assert lines == ["Loader train: 2 samples, tile decoder native libtiff (csrc/tile_decoder.cpp)"]


def test_flax_paths_follow_jax_tree_order():
    tree = {"b": {"kernel": 1, "bias": 2}, "a": {"scale": 3}}
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = ["/".join(str(k.key) for k in path) for path, _ in leaves]
    assert list(tlog._flax_paths(tree)) == want
    assert flax_to_torch({"params": tree}).keys() == {"b.weight", "b.bias", "a.scale"}
