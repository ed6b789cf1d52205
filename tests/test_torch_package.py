"""Package rules of the port: kurosiwo_torch and chip_smoke.py import
neither JAX nor the JAX package, nor json5 or orbax, which the card's
machine does not have (an AST scan), entry points run on the card unless
the caller asks for the CPU, and the kernel build stays lazy."""

import ast
import importlib
import pathlib
import pkgutil

import pytest
import torch

import kurosiwo_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kurosiwo_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "kurosiwo_tpu", "json5", "pyjson5", "orbax")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists()
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_without_building_kernels():
    names = [m.name for m in pkgutil.walk_packages(kurosiwo_torch.__path__, "kurosiwo_torch.")]
    assert "kurosiwo_torch.ops.batchnorm" in names and "kurosiwo_torch.bench" in names
    for name in names:
        importlib.import_module(name)
    from kurosiwo_torch import kernels

    assert kernels._loaded == {}


def test_kernel_sources_ship_with_the_package():
    from kurosiwo_torch import kernels

    names = {p.name for p in kernels.sources()}
    assert {"pair_sums.cu", "ce_cm.cu", "short_attention.cu", "flash_attention.cu",
            "conv3x3.cu", "conv_dw.cu", "conv_fused.cu"} <= names
    for src in kernels.sources():
        text = src.read_text()
        assert "Replaces the TPU kernel" in text or "Replaces the TPU kernels" in text
        assert "extern \"C\"" in text


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_factory_without_device_raises_on_a_cpu_box(monkeypatch):
    from kurosiwo_torch.bench import MODEL_CONFIG, build_config
    from kurosiwo_torch.models.factory import initialize_segmentation_model

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_segmentation_model(build_config("unet", 2), MODEL_CONFIG)


def test_train_and_eval_steps_without_device_raise_on_a_cpu_box(monkeypatch):
    from kurosiwo_torch.bench import MODEL_CONFIG, build_config
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.training.steps import make_eval_step, make_train_step

    cfg = build_config("unet", 2)
    model = initialize_segmentation_model(cfg, MODEL_CONFIG, device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(model, create_loss(cfg, "train"), cfg, MODEL_CONFIG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(model, create_loss(cfg, "val"), cfg, MODEL_CONFIG)


def test_bench_setup_without_cuda_raises(monkeypatch):
    from kurosiwo_torch import bench

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.setup(batch=2)


def test_mae_modules_import_without_building_kernels():
    names = [m.name for m in pkgutil.walk_packages(kurosiwo_torch.__path__, "kurosiwo_torch.")]
    slice_two = {"kurosiwo_torch.ops.short_attention", "kurosiwo_torch.ops.attention",
                 "kurosiwo_torch.ops.layernorm", "kurosiwo_torch.ops.schedules",
                 "kurosiwo_torch.models.vit", "kurosiwo_torch.models.mae",
                 "kurosiwo_torch.training.mae"}
    assert slice_two <= set(names)
    for name in sorted(slice_two):
        importlib.import_module(name)
    from kurosiwo_torch import kernels

    assert "short_attention" not in kernels._loaded


def test_mae_factory_step_and_bench_without_device_raise_on_a_cpu_box(monkeypatch):
    from kurosiwo_torch import bench
    from kurosiwo_torch.models.factory import build_mae
    from kurosiwo_torch.training.mae import make_mae_train_step

    cfg = {"num_channels": 6, "mixed_precision": False}
    mcfg = {"image_size": 32, "patch_size": 16, "dim": 32, "depth": 1, "heads": 2,
            "mlp_dim": 32, "decoder_dim": 32, "decoder_depth": 1, "decoder_heads": 2}
    model = build_mae(cfg, mcfg, device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_mae(cfg, mcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mae_train_step(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.setup(batch=2, model="mae")


def test_mae_bench_config_is_the_jax_bench_config():
    """bench.py:209-212, the MAE leg of the repository's benchmark."""
    from kurosiwo_torch.bench import MAE_CONFIG, MAE_LR, MAE_MODEL_CONFIG

    assert MAE_MODEL_CONFIG == {"image_size": 224, "patch_size": 16, "dim": 1024, "depth": 24,
                                "heads": 16, "mlp_dim": 2048, "decoder_dim": 512,
                                "decoder_depth": 8, "decoder_heads": 16, "masked_ratio": 0.75}
    assert MAE_CONFIG["num_channels"] == 6 and MAE_CONFIG["mixed_precision"] and MAE_LR == 1e-4
    text = (ROOT / "bench.py").read_text()
    for key, value in MAE_MODEL_CONFIG.items():
        assert f'"{key}": {value}' in text


def test_vit_ring_axis_names_its_roadmap_item():
    from kurosiwo_torch.models.vit import SelfAttention

    with pytest.raises(NotImplementedError, match="A12"):
        SelfAttention(64, 2, 64, ring_axis="seq")


@pytest.mark.parametrize("method,item", [
    ("unetplusplus", "A5"), ("deeplabv3", "A5"), ("upernet", "A9"), ("finetune", "A5"),
])
def test_unported_methods_name_their_roadmap_item(method, item):
    from kurosiwo_torch.models.factory import initialize_segmentation_model

    with pytest.raises(NotImplementedError, match=item):
        initialize_segmentation_model({"method": method, "num_classes": 3, "num_channels": 6},
                                      {}, device="cpu")


def test_bench_config_matches_the_jax_bench():
    import bench as jax_bench

    from kurosiwo_torch.bench import build_config

    assert build_config("unet", 128) == jax_bench.build_config("unet", 128)


def test_kernel_wrappers_reject_what_the_kernel_does_not_take():
    from kurosiwo_torch.ops import fused_tail

    logits = torch.zeros(1, 4, 4, 3)
    labels = torch.zeros(1, 4, 4, dtype=torch.int64)
    with pytest.raises(TypeError, match="int32"):
        fused_tail._check_inputs(logits, labels, torch.ones(3), fused_tail.NHWC)
    with pytest.raises(ValueError, match="do not match"):
        fused_tail._check_inputs(logits, labels.int(), torch.ones(3), fused_tail.PHASE)
    with pytest.raises(ValueError, match="contiguous"):
        fused_tail._check_inputs(logits.transpose(1, 2), labels.int(), torch.ones(3), fused_tail.NHWC)


def test_inference_modules_import_without_building_kernels():
    names = [m.name for m in pkgutil.walk_packages(kurosiwo_torch.__path__, "kurosiwo_torch.")]
    slice_three = {"kurosiwo_torch.inference", "kurosiwo_torch.ops.flash_attention"}
    assert slice_three <= set(names)
    for name in sorted(slice_three):
        importlib.import_module(name)
    from kurosiwo_torch import kernels

    assert "flash_attention" not in kernels._loaded


def test_inference_entry_points_without_device_raise_on_a_cpu_box(monkeypatch):
    import numpy as np

    from kurosiwo_torch import bench
    from kurosiwo_torch.inference import TilePredictor, vit_whole_scene
    from kurosiwo_torch.models.vit import ViT

    vit = ViT(image_size=32, patch_size=16, dim=32, depth=1, heads=2, mlp_dim=32, channels=2,
              dim_head=32)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TilePredictor(torch.nn.Identity())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vit_whole_scene(vit, np.zeros((32, 32, 2), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.setup_scene(64)


def test_vit_whole_scene_cp_names_its_roadmap_item():
    from kurosiwo_torch.inference import vit_whole_scene_cp

    with pytest.raises(NotImplementedError, match="A12"):
        vit_whole_scene_cp(None, None, None)


def test_scene_bench_uses_the_jax_scene_bench_vit():
    """scripts/bench_scene.py:67-68, the ViT-L of the whole-scene benchmark."""
    from kurosiwo_torch.bench import SCENE_VIT

    assert SCENE_VIT == {"image_size": 224, "patch_size": 16, "dim": 1024, "depth": 24,
                         "heads": 16, "mlp_dim": 2048, "channels": 6}
    text = " ".join((ROOT / "scripts" / "bench_scene.py").read_text().split())
    call = ", ".join(f"{k}={v}" for k, v in SCENE_VIT.items())
    assert f"ViT({call}, pool=\"cls\", dtype=jnp.bfloat16)" in text


def test_scene_bench_rejects_train_options():
    from kurosiwo_torch import bench

    for argv in (["--model", "scene", "--eval"], ["--model", "scene", "--set", "a=1"]):
        with pytest.raises(SystemExit):
            bench.main(argv)


def test_engine_and_cli_without_device_raise_on_a_cpu_box(monkeypatch, tmp_path):
    from kurosiwo_torch import __main__ as cli
    from kurosiwo_torch.bench import MODEL_CONFIG, build_config
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.training.engine import TaskEngine, evaluate_task, train_task

    cfg = dict(build_config("unet", 2), checkpoint_path=str(tmp_path / "run"))
    model = initialize_segmentation_model(cfg, MODEL_CONFIG, device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TaskEngine(model, cfg, MODEL_CONFIG, "segmentation", 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_task(model, [], [], [], cfg, MODEL_CONFIG, "segmentation")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_task(model, cfg, MODEL_CONFIG, "segmentation")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--config_root", str(ROOT / "configs")])
