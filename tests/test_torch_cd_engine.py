"""The change-detection task end to end on the CPU in f32 at a tiny size:
kurosiwo_torch.training.change_detection's train_change_detection and
eval_change_detection (SNUNet-ECAM at base_channel 8, batch 4, 32x32
synthetic patches, 10 samples a split, one epoch with per-epoch
checkpoints) against kurosiwo_tpu's from the same initial weights; then
the CLI (python -m kurosiwo_torch --method snunet --inputs pre_event_1
post_event, "task": "cd" in config.json, as main.py takes them) on the
repository's configs cut to the same size, and its refusals of a
change-detection method under the segmentation task and of three inputs.

Exactness classes (ROADMAP C5, as tests/test_torch_engine.py): the banks'
row sums equal and each cell of the train and val banks within 1% of the
bank's valid pixels; the mean train and val losses within rtol 5e-3; the
test mIoU within 2 points (the first step is the same function in both
frameworks, the second starts from Adam's first update, which flips sign
at near-ties, C6). The CLI: bit-exact within torch (two runs at one seed
print the same numbers).
"""

import json
import pathlib
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from kurosiwo_torch import __main__ as cli
from kurosiwo_torch.config import load_json5
from kurosiwo_torch.convert import flax_to_torch
from kurosiwo_torch.data.pipeline import Loader as TLoader
from kurosiwo_torch.models.factory import initialize_cd_model as t_init
from kurosiwo_torch.training import change_detection as t_cd
from kurosiwo_torch.training import engine as tengine
from kurosiwo_torch.training.checkpoint import CheckpointManager
from kurosiwo_tpu.data.pipeline import Loader as JLoader
from kurosiwo_tpu.models.factory import initialize_cd_model as j_init
from kurosiwo_tpu.ops import metrics as jmetrics
from kurosiwo_tpu.parallel import mesh as jmesh
from kurosiwo_tpu.training import change_detection as j_cd
from kurosiwo_tpu.training import engine as jengine

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MCFG = {"base_channel": 8, "learning_rate": 1e-3, "optimizer": "adam", "lr_schedule": None,
        "betas": [0.9, 0.009]}
SEED = 3
CFG = {
    "task": "cd", "method": "snunet", "root_path": "/nonexistent-kuro-siwo",
    "num_classes": 3, "mixed_precision": False, "batch_size": 4, "epochs": 1,
    "num_workers": 2, "print_frequency": 1000, "on_screen_prints": False,
    "wandb_activate": False, "log_AOI_metrics": False, "log_zone_metrics": False,
    "evaluate_water": True, "weighted": False, "oversampling": False,
    "loss_function": "cross_entropy", "track": "RandomEvents",
    "inputs": ["pre_event_1", "post_event"], "channels": ["vv", "vh"],
    "clamp_input": 0.15, "scale_input": "normalize", "data_mean": [0.0953, 0.0264],
    "data_std": [0.0427, 0.0215], "dem": False, "data_augmentations": False,
    "synthetic_data": True, "synthetic_size": 10, "synthetic_patch_size": 32,
    "train_acts": [130, 470], "val_acts": [514, 559, 279, 520, 437, 1111003, 1111008],
    "test_acts": [321], "class_weights": [1.0, 1.0, 1.0], "num_channels": 2,
    "train_save_checkpoint_freq": 1,
}


def _recording(engine_cls, mp, record):
    """Record the summaries of an engine's train epochs and evals."""
    train, run_eval = engine_cls.run_train_epoch, engine_cls.run_eval

    def recording_train(self, *a, **k):
        out = train(self, *a, **k)
        record.setdefault("train", []).append(out)
        return out

    def recording_eval(self, loader, settype="Val"):
        out = run_eval(self, loader, settype)
        record.setdefault(settype, []).append(out)
        return out

    mp.setattr(engine_cls, "run_train_epoch", recording_train)
    mp.setattr(engine_cls, "run_eval", recording_eval)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's train_change_detection (one epoch, on one CPU device) and its
    test eval, with its initial variables, its summaries (the confusion
    matrices included) and its checkpoint directory."""
    cfg = dict(CFG, checkpoint_path=str(tmp_path_factory.mktemp("jax") / "run"))
    record = {}
    with pytest.MonkeyPatch.context() as mp:
        summarize = jmetrics.MetricState.summarize
        mp.setattr(jmetrics.MetricState, "summarize",
                   lambda self: dict(summarize(self), cm=np.asarray(self.cm)))
        one = jmesh.create_mesh(devices=jax.devices()[:1])
        mp.setattr(jengine, "create_mesh", lambda *a, **k: one)
        init = jengine.TaskEngine.__init__

        def keep_init(self, *a, **k):
            init(self, *a, **k)
            record.setdefault("init", {
                "params": jax.tree.map(np.asarray, dict(self.state.params)),
                "batch_stats": jax.tree.map(np.asarray, dict(self.state.batch_stats))})

        mp.setattr(jengine.TaskEngine, "__init__", keep_init)
        _recording(jengine.TaskEngine, mp, record)
        loaders = [JLoader(s, cfg, SEED, process_index=0, process_count=1)
                   for s in ("train", "val", "test")]
        engine = j_cd.train_change_detection(j_init(cfg, MCFG), *loaders, cfg, MCFG, seed=0)
        record["test_miou"] = j_cd.eval_change_detection(engine, loaders[2])[2]
    record["cfg"] = cfg
    return record


def _valid_close(got, want, frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert np.abs(got - want).max() <= frac * want.sum()


def test_train_change_detection_matches_jax(jax_run, tmp_path, monkeypatch):
    cfg = dict(jax_run["cfg"], checkpoint_path=str(tmp_path / "run"))
    model = t_init(cfg, MCFG, device="cpu")
    model.load_state_dict(flax_to_torch(jax_run["init"]))
    record = {}
    _recording(tengine.TaskEngine, monkeypatch, record)
    loaders = [TLoader(s, cfg, SEED) for s in ("train", "val", "test")]
    engine = t_cd.train_change_detection(model, *loaders, cfg, MCFG, seed=0, device="cpu")
    _, _, miou = t_cd.eval_change_detection(engine, loaders[2])
    assert isinstance(engine.state.optimizer, torch.optim.Adam)
    assert engine.state.optimizer.param_groups[0]["betas"] == (0.9, 0.999)  # as optax.adam
    (train,), (want_train,) = record["train"], jax_run["train"]
    assert train["batches"] == want_train["batches"] == 2
    _valid_close(train["cm"], want_train["cm"], 1e-2)
    np.testing.assert_allclose(train["mean_loss"], want_train["mean_loss"], rtol=5e-3)
    val, want_val = record["Val"][0][3], jax_run["Val"][0][3]
    _valid_close(val["cm"], want_val["cm"], 1e-2)
    np.testing.assert_allclose(val["val_loss"], want_val["val_loss"], rtol=5e-3)
    assert abs(miou - jax_run["test_miou"]) <= 2.0
    # the per-epoch checkpoint, as JAX's CheckpointManager.save_epoch writes it
    ckpt = CheckpointManager(cfg["checkpoint_path"])
    assert ckpt.has("checkpoint_epoch=0") and ckpt.has("best_segmentation")
    jax_dir = pathlib.Path(jax_run["cfg"]["checkpoint_path"])
    assert (jax_dir / "checkpoint_epoch=0.ptr.json").exists()
    assert ckpt.load("checkpoint_epoch=0")[0]["step"] == 2


def test_cd_engine_evaluates_in_the_f32_twin(monkeypatch):
    seen = {}
    real = tengine.make_eval_step

    def spy(*a, dtype=None, **k):
        seen["dtype"], seen["task"] = dtype, a[4] if len(a) > 4 else k.get("task")
        return real(*a, dtype=dtype, **k)

    monkeypatch.setattr(tengine, "make_eval_step", spy)
    cfg = dict(CFG, mixed_precision=True)
    tengine.TaskEngine(t_init(cfg, MCFG, device="cpu"), cfg, MCFG, "cd", 1, device="cpu")
    assert seen == {"dtype": torch.float32, "task": "cd"}


def _configs(tmp_path, **top) -> pathlib.Path:
    root = tmp_path / "configs"
    shutil.copytree(ROOT / "configs", root)
    for rel, kw in (("config.json", {"mixed_precision": False, "synthetic_size": 8,
                                     "synthetic_patch_size": 32, **top}),
                    ("train/train_config.json", {"batch_size": 4, "num_workers": 2})):
        path = root / rel
        path.write_text(json.dumps({**load_json5(path), **kw}))
    return root


def test_cli_runs_snunet_change_detection(tmp_path, monkeypatch, capsys):
    """As main.py: "task": "cd" in config.json and the pair pre_event_1,
    post_event from --inputs. Two runs at one seed print the same numbers;
    each leaves checkpoint_epoch=0."""
    monkeypatch.chdir(tmp_path)
    root = _configs(tmp_path, task="cd")
    outs = []
    for _ in range(2):
        miou = cli.main(["--method", "snunet", "--inputs", "pre_event_1", "post_event",
                         "--seed", "7", "--config_root", str(root), "--device", "cpu"])
        out = capsys.readouterr().out
        printed = re.search(r"^Test Mean IOU:\s+(\S+)$", out, re.M)
        assert printed and float(printed.group(1)) == miou and 0.0 <= miou <= 100.0
        assert "'task': 'cd'" in out and "'inputs': ['pre_event_1', 'post_event']" in out
        outs.append(miou)
    assert outs[0] == outs[1]
    runs = sorted((tmp_path / "checkpoints" / "snunet").iterdir())
    assert runs and all((r / "checkpoint_epoch=0.ptr.json").exists() for r in runs)


def test_cli_refuses_three_inputs_for_change_detection(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="exactly 2 inputs.*--inputs pre_event_1 post_event"):
        cli.main(["--method", "siam-diff", "--inputs", "pre_event_1", "pre_event_2",
                  "post_event", "--config_root", str(_configs(tmp_path, task="cd")),
                  "--device", "cpu"])
    assert not (tmp_path / "checkpoints").exists()


@pytest.mark.parametrize("method", ["snunet", "hfa-net"])
def test_cli_refuses_a_cd_method_under_the_segmentation_task(tmp_path, monkeypatch, method):
    """The shipped config.json says "task": "segmentation"; main.py
    dispatches on it, and the CLI names the key to set."""
    monkeypatch.chdir(tmp_path)
    root = _configs(tmp_path)
    assert load_json5(root / "config.json")["task"] == "segmentation"
    with pytest.raises(ValueError, match='set "task": "cd" in .*config.json'):
        cli.main(["--method", method, "--config_root", str(root), "--device", "cpu"])
    assert not (tmp_path / "checkpoints").exists()
