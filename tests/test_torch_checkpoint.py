"""The port's checkpoints (kurosiwo_torch.training.checkpoint) and the
engine's resume, best-reload and eval-only behaviour: the analogues of
tests/test_resume.py, on the CPU at a tiny size (batch 4, 32x32 synthetic
patches, 8 samples a split).

Exactness class (ROADMAP C5): bit-exact within torch. A restored state is
the saved one, tensor for tensor.
"""

import os

import numpy as np
import pytest
import torch

from kurosiwo_torch.data.pipeline import Loader
from kurosiwo_torch.models.factory import initialize_segmentation_model
from kurosiwo_torch.ops.optim import AdamBF16Moments
from kurosiwo_torch.training.checkpoint import CheckpointManager
from kurosiwo_torch.training.engine import evaluate_task, train_task
from kurosiwo_torch.training.state import TrainState

torch.set_num_threads(2)

MCFG = {"backbone": "resnet18", "learning_rate": 1e-3, "lr_schedule": None,
        "optimizer": "adam"}


def _cfg(base_config, tmp_path, **kw):
    return {**base_config, "batch_size": 4, "synthetic_size": 8, "synthetic_patch_size": 32,
            "num_workers": 2, "epochs": 1, "print_frequency": 1000,
            "checkpoint_path": str(tmp_path / "run"), **kw}


def _model(cfg, seed=0):
    return initialize_segmentation_model(cfg, MCFG, device="cpu", seed=seed)


def _loaders(cfg, seed=1):
    return [Loader(m, cfg, seed) for m in ("train", "val", "test")]


def _assert_state_dicts_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def test_latest_checkpoint_resume(base_config, tmp_path, capsys):
    cfg = _cfg(base_config, tmp_path)
    engine1 = train_task(_model(cfg), *_loaders(cfg), cfg, MCFG, "segmentation", device="cpu")
    ckpt = CheckpointManager(cfg["checkpoint_path"])
    assert ckpt.has("latest")
    payload, extra = ckpt.load("latest")
    steps_per_epoch = payload["step"]
    assert steps_per_epoch == 2 and extra["epoch"] == 0

    # a restart asking for 2 epochs in all skips epoch 0
    cfg2 = dict(cfg, epochs=2, resume_checkpoint=True)
    engine2 = train_task(_model(cfg2, seed=5), *_loaders(cfg2), cfg2, MCFG, "segmentation",
                         device="cpu")
    assert "Resumed from latest checkpoint at epoch 1" in capsys.readouterr().out
    # engine2 holds the best-val weights now, so the steps come from latest
    payload, extra = ckpt.load("latest")
    assert payload["step"] == 2 * steps_per_epoch and extra["epoch"] == 1
    assert engine1.state.step == steps_per_epoch  # its one epoch is its best
    assert engine2.state.step in (steps_per_epoch, 2 * steps_per_epoch)  # the best of two


def test_resume_from_best_when_no_latest(base_config, tmp_path, capsys):
    cfg = _cfg(base_config, tmp_path)
    train_task(_model(cfg), *_loaders(cfg), cfg, MCFG, "segmentation", device="cpu")
    best_metric = CheckpointManager(cfg["checkpoint_path"]).load("best_segmentation")[1]["metric"]
    for p in (tmp_path / "run").glob("latest*"):
        p.unlink()
    cfg2 = dict(cfg, resume_checkpoint=True)
    train_task(_model(cfg2), *_loaders(cfg2), cfg2, MCFG, "segmentation", device="cpu")
    assert f"Resumed from best_segmentation (val mIoU {best_metric:.3f})" in capsys.readouterr().out


def test_final_state_is_best_checkpoint(base_config, tmp_path):
    cfg = _cfg(base_config, tmp_path, epochs=2)
    engine = train_task(_model(cfg), *_loaders(cfg, seed=3), cfg, MCFG, "segmentation",
                        device="cpu")
    payload, extra = CheckpointManager(cfg["checkpoint_path"]).load("best_segmentation")
    _assert_state_dicts_equal(engine.model.state_dict(), payload["model"])
    assert engine.state.step == payload["step"]
    text = (tmp_path / "run" / "best_segmentation.txt").read_text()
    assert text == f"epoch: {extra['epoch']}\nval_miou: {extra['metric']}\n"


def test_evaluate_task_eval_only(base_config, tmp_path):
    cfg = _cfg(base_config, tmp_path)
    with pytest.raises(FileNotFoundError, match="best_segmentation"):
        evaluate_task(_model(cfg), cfg, MCFG, "segmentation", device="cpu")
    loaders = _loaders(cfg, seed=3)
    trained = train_task(_model(cfg), *loaders, cfg, MCFG, "segmentation", device="cpu")
    evaluated = evaluate_task(_model(cfg, seed=9), cfg, MCFG, "segmentation", device="cpu")
    _assert_state_dicts_equal(evaluated.model.state_dict(), trained.model.state_dict())
    got = evaluated.run_eval(loaders[2], "Test")
    want = trained.run_eval(loaders[2], "Test")
    assert 0.0 <= got[2] <= 100.0
    np.testing.assert_array_equal(got[3]["cm"], want[3]["cm"])
    assert got[:3] == want[:3]


def _state(value: float, bf16_moments: bool = False) -> TrainState:
    model = torch.nn.Linear(3, 2)
    model.register_buffer("mean", torch.zeros(2))
    with torch.no_grad():
        model.weight.fill_(value)
        model.bias.fill_(-value)
        model.mean.fill_(value / 2)
    opt = (AdamBF16Moments if bf16_moments else torch.optim.Adam)(model.parameters(), lr=1e-2)
    model(torch.ones(4, 3)).square().sum().backward()
    opt.step()
    return TrainState(step=int(value), model=model, optimizer=opt)


def test_checkpoint_slots_never_delete_committed_copy(tmp_path):
    """Overwriting a name writes the other slot and flips the pointer only
    after that file is complete; the extra never outlives its weights."""
    ckpt = CheckpointManager(tmp_path / "ck")
    ckpt.save("latest", _state(1), extra={"epoch": 1})
    p1 = ckpt._read_ptr("latest")
    assert p1["slot"] == "latest.a" and (tmp_path / "ck" / "latest.a").exists()
    ckpt.save("latest", _state(2), extra={"epoch": 2})
    p2 = ckpt._read_ptr("latest")
    assert p2["slot"] == "latest.b" and (tmp_path / "ck" / "latest.a").exists()
    restored, extra = ckpt.restore("latest", _state(0))
    assert restored.step == 2 and extra == {"epoch": 2}
    assert restored.model.weight[0, 0].item() != 1.0
    ckpt.save("latest", _state(3))  # a save without extra leaks no old metadata
    assert ckpt._read_ptr("latest")["slot"] == "latest.a"
    assert ckpt.restore("latest", _state(0))[1] == {}


def test_failed_save_leaves_the_previous_copy_restorable(tmp_path, monkeypatch):
    ckpt = CheckpointManager(tmp_path / "ck")
    first = _state(1)
    ckpt.save("latest", first, extra={"epoch": 1})

    def fail(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(os, "replace", fail)
    with pytest.raises(OSError, match="disk gone"):
        ckpt.save("latest", _state(2), extra={"epoch": 2})
    monkeypatch.undo()
    assert ckpt._read_ptr("latest")["slot"] == "latest.a"
    restored, extra = CheckpointManager(tmp_path / "ck").restore("latest", _state(0))
    assert extra == {"epoch": 1} and restored.step == 1
    _assert_state_dicts_equal(restored.model.state_dict(), first.model.state_dict())


@pytest.mark.parametrize("bf16_moments", [False, True], ids=["adam", "adam-bf16-moments"])
def test_optimizer_state_round_trips_bitwise(tmp_path, bf16_moments):
    saved = _state(1, bf16_moments)
    ckpt = CheckpointManager(tmp_path / "ck")
    ckpt.save("latest", saved)
    restored, _ = ckpt.restore("latest", _state(7, bf16_moments))
    _assert_state_dicts_equal(restored.model.state_dict(), saved.model.state_dict())
    for p_got, p_want in zip(restored.model.parameters(), saved.model.parameters()):
        s_got, s_want = restored.optimizer.state[p_got], saved.optimizer.state[p_want]
        for k in ("exp_avg", "exp_avg_sq"):
            assert s_got[k].dtype == s_want[k].dtype
            assert torch.equal(s_got[k], s_want[k]), k
    # the next step from the restored state is the saved state's next step
    for state in (saved, restored):
        state.optimizer.zero_grad()
        state.model(torch.ones(4, 3)).sum().backward()
        state.optimizer.step()
    _assert_state_dicts_equal(restored.model.state_dict(), saved.model.state_dict())
    if bf16_moments:  # the step reads the flat buffers: the restore refilled them
        m, _ = restored.optimizer._flat[0]
        assert m.dtype == torch.bfloat16
        assert torch.equal(m, saved.optimizer._flat[0][0])


def test_restore_maps_to_the_managers_device(tmp_path):
    ckpt = CheckpointManager(tmp_path / "ck", device="cpu")
    ckpt.save("latest", _state(1))
    payload, _ = ckpt.load("latest", map_location="meta")
    assert all(t.device.type == "meta" for t in payload["model"].values())
    payload, _ = ckpt.load("latest")
    assert all(t.device.type == "cpu" for t in payload["model"].values())
