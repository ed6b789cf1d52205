"""The rest of the port's inference and its visualizations against the JAX
package's, on the CPU: ``utils/visualize`` (numpy on both sides), the
raster command line ``python -m kurosiwo_torch.inference`` on a
cv2-written 300x260 VV/VH pair with a checkpoint of the port's own,
``load_variables`` of a saved checkpoint, and the engine's
``save_visualizations``.

Exactness class (ROADMAP C5): bit-exact throughout. The visualizations and
the raster's stacked, normalized scene are numpy in both packages; the
CLI's class map is the in-process ``predict_scene`` of the same loaded
weights (one torch computation); a loaded checkpoint is the saved
``state_dict``; the PNGs are lossless.
"""

import json
import pathlib
import shutil

import cv2
import numpy as np
import pytest
import torch

from kurosiwo_torch import inference as tinf
from kurosiwo_torch.config import load_config as t_load_config
from kurosiwo_torch.config import load_json5
from kurosiwo_torch.data.pipeline import Loader as TLoader
from kurosiwo_torch.models.factory import initialize_segmentation_model as t_init
from kurosiwo_torch.training.checkpoint import CheckpointManager
from kurosiwo_torch.training.engine import TaskEngine
from kurosiwo_torch.training.state import create_train_state
from kurosiwo_torch.utils import visualize as tviz
from kurosiwo_tpu.config import load_config as j_load_config
from kurosiwo_tpu.data.normalize import normalize as j_normalize
from kurosiwo_tpu.data.tiles import _imread as j_imread
from kurosiwo_tpu.data.tiles import stack_channels as j_stack
from kurosiwo_tpu.utils import visualize as jviz

torch.set_num_threads(2)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def _images(seed, shape=(37, 29)):
    rs = np.random.RandomState(seed)
    return (rs.gamma(2.0, 0.03, shape + (2,)).astype(np.float32),
            rs.randint(0, 4, shape), rs.randint(0, 3, shape))


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("scaled", [False, True], ids=["raw", "reverse-scaled"])
def test_visualize_is_the_jax_packages(channels, scaled):
    img, mask, pred = _images(channels)
    img = np.concatenate([img, img[..., :1] / (img[..., 1:2] + 1e-7)], -1)[..., :channels]
    sv = cfg = None
    if scaled:
        sv = (np.linspace(0.02, 0.1, channels), np.linspace(0.01, 0.05, channels))
        cfg = {"scale_input": "normalize"}
    np.testing.assert_array_equal(tviz.adjust_gamma(img), jviz.adjust_gamma(img))
    got, want = tviz.sar_to_rgb(img, sv, cfg), jviz.sar_to_rgb(img, sv, cfg)
    assert got.dtype == want.dtype == np.uint8 and got.shape == img.shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tviz.overlay_mask(got, mask), jviz.overlay_mask(want, mask))
    t_trip = tviz.prediction_triptych(img, pred, mask, sv, cfg)
    j_trip = jviz.prediction_triptych(img, pred, mask, sv, cfg)
    assert list(t_trip) == list(j_trip) == ["image", "ground_truth", "prediction"]
    for k in j_trip:
        np.testing.assert_array_equal(t_trip[k], j_trip[k])
    assert tviz.to_wandb_images(t_trip) is None  # no wandb on either machine


def _write_scene(root, shape=(300, 260)):
    """A VV and a VH raster written as float32 TIFFs with cv2, NaNs in VV."""
    rs = np.random.RandomState(7)
    vv = rs.gamma(2.0, 0.04, shape).astype(np.float32)
    vh = rs.gamma(2.0, 0.01, shape).astype(np.float32)
    vv[5:9, 11:14] = np.nan
    paths = root / "vv.tif", root / "vh.tif"
    for path, img in zip(paths, (vv, vh)):
        assert cv2.imwrite(str(path), img)
    return paths


def _configs(tmp_path) -> pathlib.Path:
    """The repository's configs/ in f32 (the CPU's fast path)."""
    root = tmp_path / "configs"
    shutil.copytree(CONFIGS, root)
    path = root / "config.json"
    path.write_text(json.dumps({**load_json5(path), "mixed_precision": False}))
    return root


def _checkpoint(cfg, path, seed=3):
    """A UNet of the CLI's config (2 channels) saved as ``best_segmentation``
    with BatchNorm statistics of its own (one train-mode forward)."""
    model = t_init(cfg, cfg["model_config"], device="cpu", seed=seed)
    with torch.no_grad():
        model.train()(torch.from_numpy(np.random.RandomState(seed).randn(2, 64, 64, 2)
                                       .astype(np.float32)))
    CheckpointManager(path).save_best(create_train_state(model, cfg, cfg["model_config"]), 0, 1.0)
    return model


def test_raster_cli_writes_the_mask_of_predict_scene(tmp_path, capsys, monkeypatch):
    """The scene the CLI feeds ``predict_scene`` is JAX ``main``'s steps'
    (load_config with inputs ["post_event"], _imread, stack_channels,
    normalize) bit for bit; the mask PNG is the in-process ``predict_scene``
    of the same weights; the overlay is written; the printed counts are the
    mask's."""
    root = _configs(tmp_path)
    vv, vh = _write_scene(tmp_path)
    cfg = t_load_config(method="unet", config_root=root, overrides={"inputs": ["post_event"]})
    model = _checkpoint(cfg, tmp_path / "run")
    seen = {}
    real_predict = tinf.predict_scene

    def recording(predictor, scene, overlap):
        seen["scene"] = scene
        return real_predict(predictor, scene, overlap=overlap)

    monkeypatch.setattr(tinf, "predict_scene", recording)
    out = tmp_path / "out" / "flood.png"
    out.parent.mkdir()
    mask = tinf.main(["--vv", str(vv), "--vh", str(vh), "--checkpoint",
                      str(tmp_path / "run" / "best_segmentation"), "--out", str(out),
                      "--config_root", str(root), "--device", "cpu"])

    jcfg = j_load_config(method="unet", config_root=str(root),
                         overrides={"inputs": ["post_event"]})
    want_scene = j_normalize(j_stack(j_imread(str(vv)), j_imread(str(vh)), jcfg["channels"],
                                     jcfg.get("clamp_input")), jcfg["data_mean"], jcfg["data_std"])
    assert seen["scene"].dtype == want_scene.dtype == np.float32
    np.testing.assert_array_equal(seen["scene"], want_scene)

    predictor = tinf.TilePredictor(model, device="cpu")
    want = real_predict(predictor, want_scene, overlap=32)
    np.testing.assert_array_equal(mask, want)
    written = cv2.imread(str(out.with_suffix(".mask.png")), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(written, want)
    overlay = cv2.imread(str(out))[..., ::-1]
    np.testing.assert_array_equal(overlay, jviz.overlay_mask(jviz.sar_to_rgb(want_scene), want))
    counts = {int(k): int(v) for k, v in zip(*np.unique(want, return_counts=True))}
    assert f"scene 300x260; class pixel counts: {counts}; wrote {out}" in capsys.readouterr().out


def test_raster_cli_defaults_to_the_card(tmp_path, monkeypatch):
    vv, vh = _write_scene(tmp_path, (40, 30))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.main(["--vv", str(vv), "--vh", str(vh), "--config_root", str(CONFIGS)])


def test_load_variables_is_the_saved_state(tmp_path):
    """``dir/name`` loads the committed slot: parameters and BatchNorm
    statistics bit for bit, after a second save flipped the slot."""
    root = _configs(tmp_path)
    cfg = t_load_config(method="unet", config_root=root, overrides={"inputs": ["post_event"]})
    _checkpoint(cfg, tmp_path / "run", seed=1)
    saved = _checkpoint(cfg, tmp_path / "run", seed=2)
    assert json.loads((tmp_path / "run" / "best_segmentation.ptr.json").read_text())[
        "slot"] == "best_segmentation.b"
    fresh = t_init(cfg, cfg["model_config"], device="cpu", seed=9)
    loaded = tinf.load_variables(str(tmp_path / "run" / "best_segmentation"), fresh)
    want = saved.state_dict()
    assert loaded.keys() == want.keys() and any(k.endswith(".var") for k in want)
    for k in want:
        assert torch.equal(loaded[k], want[k]), k
    with pytest.raises(FileNotFoundError):
        tinf.load_variables(str(tmp_path / "run" / "latest"), fresh)


def test_save_visualizations_writes_the_triptych(base_config, tmp_path):
    """With ``save_visualizations`` an eval draws one batch with
    ``np.random.randint`` (as the JAX engine) and writes its sample 0's
    image, ground truth and prediction, reverse-scaled with its
    ``flood_sv1``/``flood_sv2``, side by side to ``viz/val_sample.png``:
    ``prediction_triptych`` of that batch, and JAX's."""
    cfg = dict(base_config, batch_size=2, synthetic_size=6, synthetic_patch_size=32,
               num_workers=2, save_visualizations=True, checkpoint_path=str(tmp_path / "ck"),
               inputs=["post_event"], num_channels=2)
    mcfg = {"backbone": "resnet18", "learning_rate": 1e-3}
    engine = TaskEngine(t_init(cfg, mcfg, device="cpu"), cfg, mcfg, "segmentation", 1,
                        device="cpu")
    seen = []
    real_step = engine._eval_step

    def recording(state, batch, metric):
        metric, loss, aux = real_step(state, batch, metric)
        seen.append((batch, aux["preds"].numpy()))
        return metric, loss, aux

    engine._eval_step = recording
    loader = TLoader("val", cfg, seed=2)
    np.random.seed(11)
    index = np.random.randint(0, len(loader))
    np.random.seed(11)
    engine.run_eval(loader, "Val")
    batch, preds = seen[index]
    sv = (batch["flood_sv1"][0], batch["flood_sv2"][0])
    trip = tviz.prediction_triptych(batch["post"][0], preds[0], batch["mask"][0], sv, cfg)
    j_trip = jviz.prediction_triptych(batch["post"][0], preds[0], batch["mask"][0], sv, cfg)
    panel = np.concatenate(list(trip.values()), axis=1)
    np.testing.assert_array_equal(panel, np.concatenate(list(j_trip.values()), axis=1))
    written = cv2.imread(str(tmp_path / "ck" / "viz" / "val_sample.png"))[..., ::-1]
    assert written.shape == (32, 96, 3)
    np.testing.assert_array_equal(written, panel)
