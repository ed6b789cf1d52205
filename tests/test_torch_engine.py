"""The port's segmentation engine (kurosiwo_torch.training.engine) and what it
is built from (schedules, AOI banks, the chunked eval step, the gradient
norm) against the JAX package's, on the CPU in f32 at a tiny size: UNet-
ResNet18, batch 4, 32x32 synthetic patches, 10 samples a split.

Exactness classes (ROADMAP C5):
- schedules, per-sample confusion matrices and AOI banks of given inputs:
  bit-exact;
- one engine epoch from the same weights (the JAX TaskEngine's initial
  state through convert.flax_to_torch), cross-framework banded: the banks'
  row sums (the labels) are equal, and each cell of the train, val and AOI
  banks is within 1% of the bank's valid pixels; the mean train and val
  losses within rtol 5e-3; the val mIoU within 2 points. The first step is the same function in both
  frameworks; the second starts from Adam's first update, which flips sign
  at near-ties of the gradient (C6), so predictions move on a few pixels.
  (Measured at this size: cells within 0.11% and 0.15% of the valid pixels,
  losses within 2e-4 and 1e-3.)
- the chunked eval against JAX's chunked_eval_step from the same trained
  weights: cells within 0.1% of the valid pixels (argmax near-ties), loss
  (the mean of the chunks' means, C4) rtol 1e-4; within torch, chunked and
  whole-batch banks bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch
from kurosiwo_torch.data.pipeline import Loader as TLoader
from kurosiwo_torch.models.factory import initialize_segmentation_model as t_init_model
from kurosiwo_torch.ops import metrics as tmetrics
from kurosiwo_torch.ops import schedules as tsched
from kurosiwo_torch.ops.losses import create_loss as t_create_loss
from kurosiwo_torch.training.engine import TaskEngine as TEngine
from kurosiwo_torch.training.engine import device_prefetch
from kurosiwo_torch.training.state import create_train_state as t_create_state
from kurosiwo_torch.training.steps import make_eval_step as t_eval_step
from kurosiwo_torch.training.steps import make_train_step as t_train_step
from kurosiwo_tpu.data.pipeline import Loader as JLoader
from kurosiwo_tpu.models.factory import initialize_segmentation_model as j_init_model
from kurosiwo_tpu.ops import metrics as jmetrics
from kurosiwo_tpu.ops import schedules as jsched
from kurosiwo_tpu.ops.losses import create_loss as j_create_loss
from kurosiwo_tpu.parallel.mesh import create_mesh
from kurosiwo_tpu.training import engine as jengine
from kurosiwo_tpu.training.steps import make_eval_step as j_eval_step

torch.set_num_threads(2)

MCFG = {"backbone": "resnet18", "learning_rate": 1e-3, "lr_schedule": "cosine",
        "optimizer": "adam"}
SEED = 3


# tests/conftest.py's base_config at this file's size (a module fixture
# cannot take that function-scoped one)
CFG = {
    "task": "segmentation", "method": "unet", "root_path": "/nonexistent-kuro-siwo",
    "num_classes": 3, "mixed_precision": False, "batch_size": 4, "epochs": 1,
    "num_workers": 2, "print_frequency": 1000, "on_screen_prints": False,
    "wandb_activate": False, "log_AOI_metrics": True, "log_zone_metrics": False,
    "evaluate_water": True, "weighted": False, "oversampling": False,
    "loss_function": "cross_entropy", "track": "RandomEvents",
    "inputs": ["pre_event_1", "pre_event_2", "post_event"], "channels": ["vv", "vh"],
    "clamp_input": 0.15, "scale_input": "normalize", "data_mean": [0.0953, 0.0264],
    "data_std": [0.0427, 0.0215], "dem": False, "data_augmentations": False,
    "synthetic_data": True, "synthetic_size": 10, "synthetic_patch_size": 32,
    "train_acts": [130, 470], "val_acts": [514, 559, 279, 520, 437, 1111003, 1111008],
    "test_acts": [321], "class_weights": [1.0, 1.0, 1.0], "num_channels": 6,
}


def _cfg(**kw):
    return dict(CFG, **kw)


def _tree(x):
    return jax.tree.map(np.asarray, dict(x))


@pytest.fixture(scope="module")
def jax_epoch():
    """One JAX TaskEngine epoch (train, then val) on one CPU device, with
    the banks it keeps to itself captured: its initial and trained
    variables, the train and val confusion matrices and losses, and the val
    AOI banks."""
    cfg = _cfg()
    aois = []
    with pytest.MonkeyPatch.context() as mp:
        summarize = jmetrics.MetricState.summarize
        update = jmetrics.HostAOIMetrics.update

        def summarize_with_cm(self):
            return dict(summarize(self), cm=np.asarray(self.cm))

        def recording_update(self, *a):
            aois.append(self)
            return update(self, *a)

        mp.setattr(jmetrics.MetricState, "summarize", summarize_with_cm)
        mp.setattr(jmetrics.HostAOIMetrics, "update", recording_update)
        train = JLoader("train", cfg, SEED, process_index=0, process_count=1)
        engine = jengine.TaskEngine(
            j_init_model(cfg, MCFG), cfg, MCFG, "segmentation", steps_per_epoch=len(train),
            mesh_plan=create_mesh(devices=jax.devices()[:1]), seed=0, init_size=32)
        init = {"params": _tree(engine.state.params),
                "batch_stats": _tree(engine.state.batch_stats)}
        train_summary = engine.run_train_epoch(train, 0)
        val = JLoader("val", cfg, SEED, process_index=0, process_count=1)
        _, _, miou, val_summary = engine.run_eval(val, "Val")
    return {
        "cfg": cfg, "init": init, "model": engine.model, "state": engine.state,
        "trained": {"params": _tree(engine.state.params),
                    "batch_stats": _tree(engine.state.batch_stats)},
        "train": train_summary, "val": val_summary, "miou": miou,
        "aoi": {a: cm.copy() for a, cm in aois[-1].banks.items()},
    }


def _assert_bank_close(got, want, frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert np.abs(got - want).max() <= frac * want.sum()


def _torch_model(variables, cfg):
    model = t_init_model(cfg, MCFG, device="cpu")
    model.load_state_dict(flax_to_torch(variables))
    return model


def test_one_engine_epoch_matches_the_jax_engine(jax_epoch):
    cfg = jax_epoch["cfg"]
    train = TLoader("train", cfg, SEED)
    engine = TEngine(_torch_model(jax_epoch["init"], cfg), cfg, MCFG, "segmentation",
                     steps_per_epoch=len(train), device="cpu")
    train_summary = engine.run_train_epoch(train, 0)
    _, _, miou, val_summary = engine.run_eval(TLoader("val", cfg, SEED), "Val")
    assert train_summary["batches"] == 2 and engine.state.step == 2
    assert train_summary["data_wait_s"] <= train_summary["epoch_time_s"]
    _assert_bank_close(train_summary["cm"], jax_epoch["train"]["cm"], 1e-2)
    _assert_bank_close(val_summary["cm"], jax_epoch["val"]["cm"], 1e-2)
    np.testing.assert_allclose(train_summary["mean_loss"], jax_epoch["train"]["mean_loss"],
                               rtol=5e-3)
    np.testing.assert_allclose(val_summary["val_loss"], jax_epoch["val"]["val_loss"], rtol=5e-3)
    assert abs(miou - jax_epoch["miou"]) <= 2.0
    # the val split's 10 samples (2 of them padding) over 7 activations
    assert sorted(val_summary["aoi_banks"]) == sorted(jax_epoch["aoi"])
    for act, want in jax_epoch["aoi"].items():
        _assert_bank_close(val_summary["aoi_banks"][act], want, 1e-2)
    assert sum(cm.sum() for cm in val_summary["aoi_banks"].values()) == val_summary["cm"].sum()


def test_chunked_eval_matches_jax_chunked_eval_step(jax_epoch):
    cfg = dict(jax_epoch["cfg"], eval_microbatch=2)
    batch = list(TLoader("val", cfg, SEED))[-1]  # the padded last batch
    assert batch["sample_weight"].tolist() == [1, 1, 0, 0]
    jstep = jax.jit(j_eval_step(jax_epoch["model"], j_create_loss(cfg, "val"), cfg, MCFG,
                                "segmentation", with_aoi=True))
    jms, jloss, jaux = jstep(jax_epoch["state"], jax.tree.map(jnp.asarray, batch),
                             jmetrics.MetricState.create())
    model = _torch_model(jax_epoch["trained"], cfg)
    chunked = t_eval_step(model, t_create_loss(cfg, "val"), cfg, MCFG, device="cpu",
                          with_aoi=True)
    ms, loss, aux = chunked(None, batch, tmetrics.MetricState.create())
    valid = int((batch["mask"][:2] != 3).sum())
    _assert_bank_close(ms.cm.numpy(), np.asarray(jms.cm), 1e-3)
    assert ms.cm.sum().item() == valid
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(ms.loss_sum), float(jms.loss_sum), rtol=1e-4)
    assert float(ms.count) == float(jms.count) == 2.0
    assert aux["per_sample_cm"].shape == (4, 4, 4)
    for got, want in zip(aux["per_sample_cm"].numpy(), np.asarray(jaux["per_sample_cm"])):
        _assert_bank_close(got, want, 1e-3)

    # chunking changes the loss's definition (mean of chunk means, C4) and
    # nothing else: the same banks and per-sample matrices as the whole batch
    whole = t_eval_step(model, t_create_loss(cfg, "val"), dict(cfg, eval_microbatch=0), MCFG,
                        device="cpu", with_aoi=True)
    wms, wloss, waux = whole(None, batch, tmetrics.MetricState.create())
    np.testing.assert_array_equal(ms.cm.numpy(), wms.cm.numpy())
    np.testing.assert_array_equal(aux["per_sample_cm"].numpy(), waux["per_sample_cm"].numpy())


@pytest.mark.parametrize("bsz,micro", [(4, 4), (4, 3)], ids=["not-smaller", "not-dividing"])
def test_chunked_eval_runs_whole_batches_it_cannot_split(jax_epoch, bsz, micro):
    cfg = dict(jax_epoch["cfg"], eval_microbatch=micro)
    batch = list(TLoader("val", cfg, SEED))[0]
    model = _torch_model(jax_epoch["trained"], cfg)
    ms, loss, _ = t_eval_step(model, t_create_loss(cfg, "val"), cfg, MCFG, device="cpu")(
        None, batch, tmetrics.MetricState.create())
    wms, wloss, _ = t_eval_step(model, t_create_loss(cfg, "val"), dict(cfg, eval_microbatch=0),
                                MCFG, device="cpu")(None, batch, tmetrics.MetricState.create())
    assert float(loss) == float(wloss)
    np.testing.assert_array_equal(ms.cm.numpy(), wms.cm.numpy())


def test_grad_norm_is_the_global_f32_norm(jax_epoch):
    cfg = jax_epoch["cfg"]
    model = _torch_model(jax_epoch["init"], cfg)
    step = t_train_step(model, t_create_loss(cfg, "train"), cfg, MCFG, device="cpu",
                        with_grad_norm=True)
    batch = next(iter(TLoader("train", cfg, SEED)))
    state, _, (loss, norm) = step(t_create_state(model, cfg, MCFG), batch,
                                  tmetrics.MetricState.create(), 1e-3)
    want = np.sqrt(sum(float(p.grad.double().square().sum()) for p in model.parameters()))
    np.testing.assert_allclose(float(norm), want, rtol=1e-5)
    assert loss.ndim == 0 and state.step == 1


@pytest.mark.parametrize("name,epochs", [("cosine", 5), (None, 3), ("linear", 4), ("step", 7)])
def test_lr_schedules_match_jax(name, epochs):
    cfg = {"epochs": epochs, "learning_rate": 3e-4}
    mcfg = {"lr_schedule": name, "learning_rate": 1e-3}
    got = tsched.create_lr_schedule(cfg, mcfg, steps_per_epoch=6)
    want = jsched.create_lr_schedule(cfg, mcfg, steps_per_epoch=6)
    for e in range(epochs + 2):
        assert float(got(e)) == float(want(e))


def test_unknown_lr_schedule_raises():
    with pytest.raises(NotImplementedError, match="poly"):
        tsched.create_lr_schedule({}, {"lr_schedule": "poly"}, 1)


def test_per_sample_confusion_and_aoi_banks_match_jax():
    rs = np.random.RandomState(0)
    preds = rs.randint(0, 3, (5, 9, 7)).astype(np.int32)
    labels = rs.randint(0, 4, (5, 9, 7)).astype(np.int32)
    got = tmetrics.per_sample_confusion(torch.from_numpy(preds), torch.from_numpy(labels))
    want = np.asarray(jmetrics.per_sample_confusion(jnp.asarray(preds), jnp.asarray(labels)))
    np.testing.assert_array_equal(got.numpy(), want)
    acts = np.asarray([130, 470, 130, 514, 470])
    t_banks, j_banks = tmetrics.HostAOIMetrics(), jmetrics.HostAOIMetrics()
    for _ in range(2):
        t_banks.update(got.numpy(), acts)
        j_banks.update(want, acts)
    assert sorted(t_banks.banks) == sorted(j_banks.banks) == [130, 470, 514]
    for a in j_banks.banks:
        np.testing.assert_array_equal(t_banks.banks[a], j_banks.banks[a])
    t_sum, j_sum = t_banks.summarize(), j_banks.summarize()
    for a in j_sum:
        for k in ("iou", "fscore", "accuracy"):
            np.testing.assert_array_equal(t_sum[a][k], np.asarray(j_sum[a][k]))


def test_device_prefetch_passes_cpu_batches_through():
    batches = [{"post": np.zeros((2, 4, 4, 2), np.float32), "activation": np.arange(2)}]
    assert list(device_prefetch(batches, "cpu")) == batches


def _reference_files(tmp_path) -> dict:
    """A seeded smp UNet-ResNet18 .pt of the engine's 6 channels and a
    3-channel torchvision resnet18 .pth, in the reference's key layouts."""
    import torch_ref_layout as ref
    from kurosiwo_tpu.models.resnet import ResNetEncoder

    unet = ref.jax_shapes(j_init_model(CFG, MCFG), jnp.zeros((1, 32, 32, 6)), train=False)
    enc = ref.jax_shapes(ResNetEncoder("resnet18"), jnp.zeros((1, 32, 32, 3)), train=False)
    files = {"pretrained_checkpoint": (tmp_path / "best.pt", ref.SMP_UNET, unet),
             "pretrained_encoder": (tmp_path / "resnet18.pth", ref.resnet_rules(), enc)}
    for path, rules, shapes in files.values():
        torch.save({k: torch.from_numpy(v) for k, v in
                    ref.reference_state(shapes, rules, 1).items()}, path)
    return {k: v[0] for k, v in files.items()}


@pytest.mark.parametrize("kw", [
    {"save_visualizations": True}, {"pretrained_checkpoint": True}, {"pretrained_encoder": True},
], ids=["visualizations", "pretrained_checkpoint", "pretrained_encoder"])
def test_engine_refuses_what_is_not_ported(kw, tmp_path):
    """What the engine once refused, now ported: ``save_visualizations``
    (A11) builds with the eval step's predictions on
    (``tests/test_torch_raster_cli.py`` holds the PNG it writes); the
    pretrained weights (A13) load at init into the model's own tensors, the
    ones the optimizer holds: a reference smp UNet .pt whole
    (``pretrained_checkpoint``), a torchvision resnet18 .pth into the
    encoder (``pretrained_encoder``; its 3-channel stem leaves the 6-channel
    model's stem, affine and statistics at their init). The JAX engine's
    state after the same loads: tests/test_torch_parity_harness.py."""
    from kurosiwo_torch import convert as tconv

    if "save_visualizations" in kw:
        cfg = _cfg(**kw)
        engine = TEngine(t_init_model(cfg, MCFG, device="cpu"), cfg, MCFG, "segmentation", 1,
                         device="cpu")
        assert engine.viz_enabled
        return
    (key,) = kw
    path = _reference_files(tmp_path)[key]
    cfg = _cfg(**{key: str(path)})
    model = t_init_model(cfg, MCFG, device="cpu", seed=SEED)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    params = list(model.parameters())
    engine = TEngine(model, cfg, MCFG, "segmentation", 1, device="cpu")
    assert [p for g in engine.state.optimizer.param_groups for p in g["params"]] == params
    got = engine.state.model.state_dict()
    if key == "pretrained_checkpoint":
        want = tconv.convert(path, "unet")
    else:
        enc = tconv.convert_torchvision_resnet(tconv.load_torch_state_dict(path))
        want = {f"encoder.{k}": v for k, v in enc.items() if not k.startswith("stem.")}
        want.update({k: v for k, v in init.items() if not k.startswith("encoder.")
                     or k.startswith("encoder.stem.")})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("installed", [True, False], ids=["wandb-installed", "wandb-absent"])
def test_wandb_request_raises_before_any_side_effect_or_prints(monkeypatch, tmp_path, capsys,
                                                               installed):
    import importlib.util

    from kurosiwo_torch.utils.logging import MetricLogger

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: (object() if installed else None) if name == "wandb"
                        else real(name, *a))
    cfg = _cfg(wandb_activate=True, on_screen_prints=False, checkpoint_path=str(tmp_path))
    if installed:  # the wandb sink is A14's: refused before a run or id.json exists
        with pytest.raises(NotImplementedError, match="wandb.*A14"):
            TEngine(t_init_model(cfg, MCFG, device="cpu"), cfg, MCFG, "segmentation", 1,
                    device="cpu")
        assert list(tmp_path.iterdir()) == []
    else:  # as the JAX logger: stdout in its place
        logger = MetricLogger(cfg)
        logger.log_train_iteration(0, 0, 0.5, 1e-3)
        out = capsys.readouterr().out
        assert "not installed" in out and '"Train Loss": 0.5' in out


def test_engine_refuses_other_tasks():
    """The engine runs the segmentation, change-detection and recurrent
    tasks (A7 ported: a recurrent engine builds, with plain Adam) and
    refuses any other task, naming the ones it has."""
    from kurosiwo_torch.models.factory import initialize_recurrent_model

    cfg = _cfg(method="convlstm", num_channels=2)
    engine = TEngine(initialize_recurrent_model(cfg, MCFG, device="cpu"), cfg, MCFG,
                     "recurrent", 1, device="cpu")
    assert engine.task == "recurrent" and type(engine.state.optimizer) is torch.optim.Adam
    with pytest.raises(NotImplementedError, match="has no task 'mae'"):
        TEngine(torch.nn.Identity(), cfg, MCFG, "mae", 1, device="cpu")


def test_pretrained_keys_warn_like_jax():
    cfg = _cfg(pretrained=True, encoder_weights="imagenet")
    with pytest.warns(UserWarning, match="RANDOM init"):
        TEngine(t_init_model(cfg, MCFG, device="cpu"), cfg, MCFG, "segmentation", 1,
                device="cpu")


def test_f32_twin_is_the_default_eval_of_a_bf16_model(monkeypatch):
    from kurosiwo_torch.training import engine as tengine

    seen = {}

    def spy(*a, dtype=None, **k):
        seen["dtype"] = dtype
        return t_eval_step(*a, dtype=dtype, **k)

    monkeypatch.setattr(tengine, "make_eval_step", spy)
    for f32_eval, want in ((True, torch.float32), (False, None)):
        cfg = _cfg(mixed_precision=True, f32_eval=f32_eval)
        TEngine(t_init_model(cfg, MCFG, device="cpu"), cfg, MCFG, "segmentation", 1,
                device="cpu")
        assert seen["dtype"] == want


def test_augmented_epoch_repeats_bitwise_at_one_seed():
    """With data_augmentations (the shipped pipeline, its crop at the patch
    size) the engine draws from its generator, seeded from the engine's
    seed: two engines from the same weights and seed train the same epoch
    bit for bit, and another seed draws other crops. Exactness class:
    bit-exact within torch."""
    import json
    import pathlib

    aug = json.loads((pathlib.Path(__file__).resolve().parent.parent / "configs"
                      / "augmentations" / "augmentation.json").read_text())["augmentations"]
    aug["RandomResizedCrop"] = dict(aug["RandomResizedCrop"], value=32)
    cfg = _cfg(data_augmentations=True, augmentations=aug, log_AOI_metrics=False)
    init = t_init_model(cfg, MCFG, device="cpu", seed=SEED).state_dict()

    def epoch(seed):
        model = t_init_model(cfg, MCFG, device="cpu")
        model.load_state_dict(init)
        engine = TEngine(model, cfg, MCFG, "segmentation", 2, device="cpu", seed=seed)
        summary = engine.run_train_epoch(TLoader("train", cfg, SEED), 0)
        return summary, {k: v.clone() for k, v in model.state_dict().items()}

    (a, wa), (b, wb), (c, _) = epoch(7), epoch(7), epoch(8)
    assert a["batches"] == 2 and a["mean_loss"] == b["mean_loss"]
    np.testing.assert_array_equal(a["cm"], b["cm"])
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert c["mean_loss"] != a["mean_loss"]
