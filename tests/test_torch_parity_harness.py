"""The port's leg of tests/test_parity_harness.py: the accuracy-parity
harness (kurosiwo_torch/parity.py) and the engine's weight routes
(``pretrained_checkpoint``, ``pretrained_encoder``, ``pretrained_upernet``)
against the JAX package's, on the CPU, from seeded files in the reference's
key layouts (tests/torch_ref_layout.py). They need no reference tree.

Bands: the harness's test confusion matrix within 0.1% of the split's
valid pixels of JAX's, entry by entry (ROADMAP C5/C6's cross-framework
band; f32 on both sides, argmax flips only at near-ties), and its F1 and
IoU within 0.1 points; the loaded weights bit-exact with the JAX engine's
(``flax_to_torch`` of its state), apart from what each package initialises
itself (the UNet's decoder beside a grafted encoder, a 6-channel stem).
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("HF_HUB_OFFLINE", "1")  # local save_pretrained directories only
os.environ.setdefault("USE_TF", "0")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cd_parity as cdp
import torch_ref_layout as ref
from kurosiwo_torch import convert as tconv
from kurosiwo_torch import parity as tparity
from kurosiwo_torch.convert import flax_to_torch
from kurosiwo_torch.training import engine as tengine
from kurosiwo_tpu import parity as jparity
from kurosiwo_tpu.models import factory as jfac
from kurosiwo_tpu.models.resnet import ResNetEncoder
from kurosiwo_tpu.ops import metrics as jmetrics
from kurosiwo_tpu.training import engine as jengine

ROOT = Path(__file__).resolve().parents[1]
SIDE = 32
OVERRIDE = {"synthetic_size": 16, "synthetic_patch_size": SIDE, "num_workers": 2,
            "base_channel": 8, "log_AOI_metrics": False}
ARGS = ["--batch_size", "8", "--config_root", str(ROOT / "configs"), "--seed", "5"]


def _checkpoint(tmp_path, model: str) -> Path:
    """A seeded reference-layout .pt of ``model`` at the harness's config."""
    if model == "unet":
        cfg = {"method": "unet", "num_classes": 3, "num_channels": 6, "mixed_precision": False}
        shapes = ref.jax_shapes(jfac.initialize_segmentation_model(cfg, {"backbone": "resnet18"}),
                                jnp.zeros((1, SIDE, SIDE, 6)), train=False)
        sd = ref.reference_state(shapes, ref.SMP_UNET, 11)
    else:
        shapes = ref.cd_shapes(jfac.initialize_cd_model(cdp.config("snunet"), {"base_channel": 8}),
                               SIDE)
        sd = ref.reference_state(shapes, ref.SNUNET, 12)
    path = tmp_path / f"{model}.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


@pytest.fixture
def fast_jax_engine(monkeypatch):
    """JAX's TaskEngine with its init one jit and its steps compiled at
    XLA's lowest optimization level (torch_cd_parity.FastInit, FastJax), in
    place of an op-by-op init that compiles each op."""
    real = jengine.create_train_state
    monkeypatch.setattr(jengine, "create_train_state",
                        lambda model, *a, **kw: real(cdp.FastInit(model), *a, **kw))
    monkeypatch.setattr(jengine, "jax", cdp.FastJax())


def _recording(monkeypatch, module, record: dict) -> None:
    """The engine's state after its load and before its eval."""
    real = module.TaskEngine.run_eval

    def run_eval(self, *a, **kw):
        record["state"] = self.state
        return real(self, *a, **kw)

    monkeypatch.setattr(module.TaskEngine, "run_eval", run_eval)


@pytest.mark.parametrize("model", ["unet", "snunet"])
def test_parity_harness_matches_jax(model, tmp_path, monkeypatch, capsys, fast_jax_engine):
    """``python -m kurosiwo_torch.parity --device cpu --model <model>``
    (its ``main``) against ``kurosiwo_tpu.parity.run`` on the same .pt and
    synthetic test split: the report's keys, the confusion counts, F1 and
    IoU in the band above; the weights each engine evaluated, bit-exact."""
    import json

    path = _checkpoint(tmp_path, model)
    argv = ["--checkpoint", str(path), "--model", model, *ARGS,
            "--override", json.dumps(OVERRIDE), "--expected-f1", "50", "--tolerance", "100"]
    jax_cm: list = []
    real = jmetrics.MetricState.summarize
    monkeypatch.setattr(jmetrics.MetricState, "summarize",
                        lambda self: jax_cm.append(np.asarray(self.cm)) or real(self))
    jrec, trec = {}, {}
    _recording(monkeypatch, jengine, jrec)
    _recording(monkeypatch, tengine, trec)
    want = jparity.run(jparity.build_parser().parse_args(argv))
    got = tparity.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"Loaded pretrained_checkpoint {path}\n")
    assert json.loads(out[out.index("{"):]) == got

    assert set(got) == set(want) | {"test_confusion"}
    cm, jcm = np.asarray(got["test_confusion"]), jax_cm[-1]
    pixels = 16 * SIDE * SIDE
    assert cm.sum() == jcm.sum() > 0.5 * pixels  # every valid pixel of the split, once
    assert np.abs(cm - jcm).max() <= 1e-3 * pixels, (cm, jcm)
    for k in ("test_accuracy", "test_mean_f1", "test_mean_iou", "delta_f1"):
        assert abs(got[k] - want[k]) <= 0.1, (k, got[k], want[k])
    np.testing.assert_allclose(got["per_class_f1"], want["per_class_f1"], atol=0.1)
    np.testing.assert_allclose(got["per_class_iou"], want["per_class_iou"], atol=0.1)
    assert got["f1_within_tolerance"] is want["f1_within_tolerance"] is True

    # the pretrained_checkpoint route of both engines: the file, whole
    jstate = flax_to_torch({"params": jrec["state"].params,
                            "batch_stats": jrec["state"].batch_stats})
    tstate = trec["state"].model.state_dict()
    assert sorted(tstate) == sorted(jstate)
    for k, v in jstate.items():
        assert torch.equal(tstate[k], v), k


def test_parity_harness_fails_outside_tolerance(tmp_path):
    """``--expected-f1`` farther than ``--tolerance`` from the test F1:
    ``python -m kurosiwo_torch.parity`` exits non-zero, PARITY FAILED."""
    import json

    path = _checkpoint(tmp_path, "snunet")
    proc = subprocess.run(
        [sys.executable, "-m", "kurosiwo_torch.parity", "--checkpoint", str(path), "--model",
         "snunet", *ARGS, "--override", json.dumps(OVERRIDE), "--expected-f1", "150",
         "--tolerance", "0.5", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode != 0
    assert "PARITY FAILED: ['f1_within_tolerance']" in proc.stderr, proc.stderr[-2000:]
    assert json.loads(proc.stdout[proc.stdout.index("{"):])["f1_within_tolerance"] is False


@pytest.mark.parametrize("channels", [3, 6])
def test_engine_pretrained_encoder_matches_jax(channels, tmp_path, fast_jax_engine):
    """A torchvision resnet18 .pth grafted by each engine into a UNet of
    ``channels`` inputs: the encoder bit-exact with the JAX engine's, the
    stem too at 3 channels; at 6 the stem conv keeps the port's init and
    its BatchNorm (affine and statistics) the init both packages share."""
    shapes = ref.jax_shapes(ResNetEncoder("resnet18"), jnp.zeros((1, 32, 32, 3)), train=False)
    path = tmp_path / "resnet18.pth"
    torch.save({k: torch.from_numpy(v) for k, v in
                ref.reference_state(shapes, ref.resnet_rules(), 13).items()}, path)
    cfg = {"task": "segmentation", "method": "unet", "num_classes": 3, "num_channels": channels,
           "mixed_precision": False, "weighted": False, "loss_function": "cross_entropy",
           "log_zone_metrics": False, "log_AOI_metrics": False, "batch_size": 2,
           "pretrained_encoder": str(path), "synthetic_patch_size": SIDE}
    mcfg = {"backbone": "resnet18", "learning_rate": 1e-3, "optimizer": "adam"}
    j = jengine.TaskEngine(jfac.initialize_segmentation_model(cfg, mcfg), cfg, mcfg,
                           "segmentation", steps_per_epoch=1, init_size=SIDE)
    jstate = flax_to_torch({"params": j.state.params, "batch_stats": j.state.batch_stats})
    from kurosiwo_torch.models.factory import initialize_segmentation_model

    model = initialize_segmentation_model(cfg, mcfg, device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    t = tengine.TaskEngine(model, cfg, mcfg, "segmentation", 1, device="cpu")
    tstate = t.state.model.state_dict()
    assert sorted(tstate) == sorted(jstate)
    for k, v in jstate.items():
        if not k.startswith("encoder."):
            assert torch.equal(tstate[k], init[k]), k  # each package's own init
        elif k == "encoder.stem.Conv_0.weight" and channels == 6:
            assert torch.equal(tstate[k], init[k])
        else:
            assert torch.equal(tstate[k], v), k


def test_engine_pretrained_upernet_matches_jax(tmp_path):
    """``pretrained_upernet``: a small HF ConvNeXt UperNet (the factory's
    512-wide head on a narrow backbone) saved with
    ``save_pretrained``; each package's ``load_pretrained_upernet`` after
    ``torch.manual_seed(0)`` (the fresh first conv and classifier come from
    torch's global RNG) gives the same state, bit-exact; the port's engine
    loads it into a UperNet of that width; a name that is not a local
    directory is refused."""
    transformers = pytest.importorskip(
        "transformers", reason="pretrained_upernet reads a transformers model")
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_tpu import convert as jconv

    bc = transformers.ConvNextConfig(num_channels=3, hidden_sizes=[16, 32, 64, 128],
                                     depths=[1, 1, 2, 1],
                                     out_features=["stage1", "stage2", "stage3", "stage4"])
    torch.manual_seed(1)
    transformers.UperNetForSemanticSegmentation(transformers.UperNetConfig(
        backbone_config=bc, hidden_size=512, num_labels=150)).save_pretrained(tmp_path / "hf")
    torch.manual_seed(0)
    want = flax_to_torch(jconv.load_pretrained_upernet(str(tmp_path / "hf"), 6, 3))
    torch.manual_seed(0)
    got = tconv.load_pretrained_upernet(tmp_path / "hf", 6, 3)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    cfg = {"task": "segmentation", "method": "upernet", "num_classes": 3, "num_channels": 6,
           "mixed_precision": False, "weighted": False, "loss_function": "cross_entropy",
           "log_zone_metrics": False, "log_AOI_metrics": False, "batch_size": 2,
           "synthetic_patch_size": 64, "pretrained_upernet": str(tmp_path / "hf")}
    mcfg = {"backbone": "convnext_tiny", "backbone_spec": [[1, 1, 2, 1], [16, 32, 64, 128]],
            "learning_rate": 1e-3, "optimizer": "adam"}
    model = initialize_segmentation_model(cfg, mcfg, device="cpu")
    torch.manual_seed(0)
    t = tengine.TaskEngine(model, cfg, mcfg, "segmentation", 1, device="cpu")
    for k, v in t.state.model.state_dict().items():
        assert torch.equal(v, got[k]), k
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        tconv.load_pretrained_upernet("openmmlab/upernet-convnext-tiny", 6, 3)


def test_parity_parser_mirrors_jax():
    """The same flags as the JAX harness, plus --device (default cuda)."""
    def flags(parser: argparse.ArgumentParser) -> dict:
        return {a.dest: (a.default, tuple(a.choices or ())) for a in parser._actions
                if a.dest != "help"}

    t, j = flags(tparity.build_parser()), flags(jparity.build_parser())
    assert t.pop("device") == ("cuda", ())
    assert t == j
