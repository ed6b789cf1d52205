"""The segmentation zoo's building blocks and entry points, on the CPU:
``ops/nn.adaptive_avg_pool`` against JAX's at divisible and non-divisible
bins (7 -> 1, 2, 3, 6; 8 -> 4) and against torch's AdaptiveAvgPool2d,
forward and gradient; ``avg_pool`` against JAX's; the ``SAME`` padding of
the patchify convs against flax's; the factory building every backbone of
UperNet, the Bottleneck trunks of the UNet and DeepLabV3+, and the
finetuner's three heads, with the flax tree's names; the finetuner's
refusal of a synthetic patch size other than its ``image_size``; the
bench's zoo legs on the shipped method configs; and the CLI for one zoo
method (DeepLabV3+) on a tiny synthetic split.

Exactness class (ROADMAP C5): f32 across frameworks within 1e-6 for the
pools and the conv; the names exact.
"""

import json
import pathlib
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kurosiwo_torch.convert import flax_to_torch
from kurosiwo_torch.models.factory import initialize_segmentation_model
from kurosiwo_torch.ops import nn as tnn
from kurosiwo_tpu.models.factory import initialize_segmentation_model as j_init
from kurosiwo_tpu.ops import nn as jnn

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("hw,out", [((7, 7), (1, 1)), ((7, 7), (2, 2)), ((7, 7), (3, 3)),
                                    ((7, 7), (6, 6)), ((8, 8), (4, 4)), ((2, 5), (6, 3))],
                         ids=["7-1", "7-2", "7-3", "7-6", "8-4", "2x5-6x3"])
def test_adaptive_avg_pool_matches_jax_and_torch(hw, out):
    x = _x((2, *hw, 5))
    dy = _x((2, *out, 5), seed=1)
    xt = torch.from_numpy(x).requires_grad_()
    got = tnn.adaptive_avg_pool(xt, out)
    (gx,) = torch.autograd.grad((got * torch.from_numpy(dy)).sum(), xt)
    want, vjp = jax.vjp(lambda a: jnn.adaptive_avg_pool(a, out), jnp.asarray(x))
    (wx,) = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=1e-6)
    lib = F.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), out)
    np.testing.assert_allclose(got.detach().numpy(), lib.permute(0, 2, 3, 1).numpy(), atol=1e-6)


def test_adaptive_avg_pool_keeps_bf16():
    y = tnn.adaptive_avg_pool(torch.ones(1, 7, 7, 2, dtype=torch.bfloat16), (3, 3))
    assert y.dtype == torch.bfloat16 and torch.equal(y, torch.ones_like(y))


@pytest.mark.parametrize("window,stride,padding", [(2, 2, "VALID"), (3, 2, "VALID"),
                                                    (3, 1, ((1, 1), (1, 1)))])
def test_avg_pool_matches_jax(window, stride, padding):
    x = _x((2, 9, 8, 3))
    got = tnn.avg_pool(torch.from_numpy(x), window, stride, padding)
    want = jnn.avg_pool(jnp.asarray(x), window, stride, padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("side,kernel,stride", [(13, 4, 4), (7, 2, 2), (8, 2, 2), (9, 3, 1)])
def test_same_padding_conv_matches_flax(side, kernel, stride):
    import flax.linen as fnn

    x = _x((2, side, side, 3))
    conv = tnn.Conv(3, 4, kernel, stride, padding="SAME", bias=True,
                    generator=torch.Generator().manual_seed(0))
    conv.bias.data.normal_(generator=torch.Generator().manual_seed(1))
    v = {"params": {"kernel": conv.weight.detach().numpy().transpose(2, 3, 1, 0),
                    "bias": conv.bias.detach().numpy()}}
    want = fnn.Conv(4, (kernel, kernel), strides=stride).apply(v, jnp.asarray(x))
    got = conv(torch.from_numpy(x), torch.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


# (method, model config, config keys, input side) that the names test
# builds beyond tests/test_torch_package.py's defaults: every UperNet
# backbone (Swin at 56x56, where its stages' windows are 7, 7, 4, 2), the
# Bottleneck trunks of the UNet, UNet++ and DeepLabV3+, the finetuner's other heads
BUILDS = [
    ("upernet", {"backbone": b}, {}, 64)
    for b in ("convnext_small", "convnext_base")
] + [
    ("upernet", {"backbone": b}, {"synthetic_patch_size": 56}, 56)
    for b in ("swin_tiny", "swin_small", "swin_base")
] + [
    (m, {"backbone": b}, {}, 64)
    for m, b in (("unet", "resnet50"), ("unet", "resnet101"), ("deeplabv3", "resnet50"),
                 ("deeplabv3", "resnet101"), ("unet++", "resnet50"))
] + [
    ("finetune", {}, {"decoder": True, "image_size": 64, "dim": 64, "depth": 1, "heads": 2,
                      "mlp_dim": 64}, 64),
    ("finetune", {}, {"image_size": 64, "dim": 64, "depth": 1, "heads": 2, "mlp_dim": 64}, 64),
]


@pytest.mark.parametrize("method,mcfg,keys,side", BUILDS,
                         ids=[f"{b[0]}-{b[1].get('backbone') or sorted(b[2])[0]}" for b in BUILDS])
def test_factory_builds_each_backbone_with_the_flax_tree_names(monkeypatch, method, mcfg, keys,
                                                              side):
    """The factory's model at each backbone (full width) with the flax tree's
    names and shapes; the convs' and Dense layers' truncated-normal init is
    replaced by zeros here, which changes no name or shape and saves most of
    a build's time on the CPU."""
    monkeypatch.setattr(tnn, "lecun_normal_", lambda w, fan_in, generator=None: w.zero_())
    cfg = {"method": method, "num_classes": 3, "num_channels": 6, **keys}
    model = initialize_segmentation_model(cfg, mcfg, device="cpu")
    shapes = jax.eval_shape(lambda: j_init(dict(cfg, mixed_precision=False), mcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, side, side, 6), jnp.float32)))
    want = flax_to_torch(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes)))
    assert {k: tuple(t.shape) for k, t in model.state_dict().items()} == {
        k: tuple(t.shape) for k, t in want.items()}
    if method == "finetune":
        assert model.head_kind == ("decoder" if keys.get("decoder") else "linear")


def test_finetune_refuses_a_synthetic_patch_size_other_than_image_size():
    cfg = {"method": "finetune", "num_classes": 3, "num_channels": 6, "image_size": 224,
           "synthetic_patch_size": 32, "dim": 64, "depth": 1, "heads": 2, "mlp_dim": 64}
    with pytest.raises(ValueError, match="image_size.*synthetic_patch_size"):
        initialize_segmentation_model(cfg, {}, device="cpu")


@pytest.mark.parametrize("method", ["unet++", "deeplabv3", "upernet", "finetune"])
def test_bench_zoo_legs_use_the_shipped_method_configs(method):
    """Each zoo leg is the UNet leg's config with the method swapped in
    (the repository's bench.py) and the shipped method config's model keys;
    the finetune leg finetune.json's ViT and head at its lr."""
    import bench as jax_bench

    from kurosiwo_torch import bench
    from kurosiwo_torch.config import load_json5

    path = next((ROOT / "configs" / "method" / method).glob("*.json"))
    shipped = load_json5(path)
    cfg = bench.build_config(method, 128)
    unet = jax_bench.build_config("unet", 128)
    assert {k: v for k, v in cfg.items() if k in unet and k != "method"} == {
        k: v for k, v in unet.items() if k != "method"}
    for key, value in bench.ZOO_MODEL_CONFIGS[method].items():
        assert shipped[key] == value
    if method == "finetune":
        assert {k: shipped[k] for k in bench.FINETUNE_CONFIG} == bench.FINETUNE_CONFIG
        assert bench.FINETUNE_LR == shipped["learning_rate"]


def test_cli_runs_deeplabv3(tmp_path, monkeypatch, capsys):
    """python -m kurosiwo_torch --method deeplabv3 --device cpu on the
    repository's configs cut to batch 4, 32x32 and 8 samples a split:
    exit 0, a test mIoU, the checkpoints under DeepLabv3/resnet18."""
    from kurosiwo_torch import __main__ as cli
    from kurosiwo_torch.config import load_json5

    monkeypatch.chdir(tmp_path)
    root = tmp_path / "configs"
    shutil.copytree(ROOT / "configs", root)
    for rel, kw in (("config.json", {"mixed_precision": False, "synthetic_size": 8,
                                     "synthetic_patch_size": 32}),
                    ("train/train_config.json", {"batch_size": 4, "num_workers": 2})):
        path = root / rel
        path.write_text(json.dumps({**load_json5(path), **kw}))
    with pytest.warns(UserWarning, match="RANDOM init"):
        miou = cli.main(["--method", "deeplabv3", "--seed", "7", "--config_root", str(root),
                         "--device", "cpu"])
    out = capsys.readouterr().out
    printed = re.search(r"^Test Mean IOU:\s+(\S+)$", out, re.M)
    assert printed and float(printed.group(1)) == miou and 0.0 <= miou <= 100.0
    run = tmp_path / "checkpoints/DeepLabv3/resnet18/vv-vh_patches_3/RandomEvents"
    assert (run / "latest.ptr.json").exists()


def test_zoo_steps_keep_the_plain_tail_and_an_explicit_fused_tail_matches_it():
    """The fused CE + cm tail stays off (``auto``) for every zoo method on
    the card, as JAX's ``resolve_fused_tail`` keeps it UNet-only; an
    explicit ``fused_tail: true`` takes the zoo's f32 logits (its plain
    version here) to the plain tail's loss and confusion matrix."""
    from kurosiwo_torch.ops.fused_tail import resolve_fused_tail
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.state import create_train_state
    from kurosiwo_torch.training.steps import make_train_step

    for method in ("unet++", "unetplusplus", "deeplabv3", "upernet", "finetune"):
        assert resolve_fused_tail({"method": method}, "segmentation", {}, device="cuda") is None
    assert resolve_fused_tail({"method": "unet"}, "segmentation", {}, device="cuda") is True
    rs = np.random.RandomState(4)
    batch = {k: rs.randn(2, 32, 32, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    batch["mask"] = rs.randint(0, 4, (2, 32, 32)).astype(np.int32)
    res = {}
    for tail in (True, False):
        cfg = {"task": "segmentation", "method": "deeplabv3", "num_classes": 3,
               "num_channels": 6, "inputs": ["pre_event_1", "pre_event_2", "post_event"],
               "class_weights": [0.4, 14.0, 8.2], "weighted": True,
               "loss_function": "cross_entropy", "mixed_precision": False, "fused_tail": tail}
        model = initialize_segmentation_model(cfg, {}, device="cpu", seed=1)
        state = create_train_state(model, cfg, {"learning_rate": 1e-3})
        step = make_train_step(model, create_loss(cfg, "train"), cfg, {}, device="cpu")
        _, ms, loss = step(state, batch, MetricState.create(), 1e-3)
        res[tail] = (float(loss), ms.cm.numpy())
    np.testing.assert_allclose(res[True][0], res[False][0], rtol=1e-6)
    np.testing.assert_array_equal(res[True][1], res[False][1])


def test_upernet_config_runs_a_constant_lr_and_adam_without_decay():
    """upernet.json's ``"lr_schedule": null`` is a constant learning rate,
    and its ``weight_decay`` of 1e-4 is not read by the segmentation Adam,
    as in the JAX package (``ops/optim.py:152-172``)."""
    from kurosiwo_torch.config import load_json5
    from kurosiwo_torch.ops.optim import create_optimizer
    from kurosiwo_torch.ops.schedules import create_lr_schedule

    mcfg = load_json5(ROOT / "configs" / "method" / "upernet" / "upernet.json")
    assert mcfg["lr_schedule"] is None and mcfg["weight_decay"] == 1e-4
    schedule = create_lr_schedule({"epochs": 3}, mcfg, steps_per_epoch=5)
    assert [schedule(e) for e in (0, 1, 2.5)] == [1e-4] * 3
    opt = create_optimizer([torch.nn.Parameter(torch.zeros(2))], {}, mcfg, "segmentation")
    assert isinstance(opt, torch.optim.Adam) and opt.defaults["weight_decay"] == 0
    assert opt.defaults["lr"] == 1e-4
