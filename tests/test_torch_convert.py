"""The port's converters from the reference's torch checkpoints
(kurosiwo_torch/convert.py) against the JAX package's (kurosiwo_tpu/convert.py).

For each of the 15 ``CONVERTERS`` entries (the finetuner in its three head
layouts, TransUNet-CD in both encoder forms, UperNet on ConvNeXt and Swin)
and for ``convert_torchvision_resnet`` + ``graft_encoder`` (resnet18 at 3
and 6 input channels; resnet50's Bottleneck converted alone), on a seeded state_dict in
the reference's key layout (tests/torch_ref_layout.py; UperNet's from a
tiny ``transformers`` model built from a config):

  * the JAX converter's tree has exactly the JAX model's init structure
    and shapes, which shows the fixture right without the port;
  * the port's converter gives ``flax_to_torch`` of the JAX converter's
    tree, bit for bit, keys and values;
  * the output loads into the port's model with every parameter covered.

The UNet, SNUNet and the ConvNeXt UperNet also run one f32 forward each,
the JAX model and the port's with their converted weights, in the C5
cross-framework band (atol 5e-4; 1e-3 for UperNet). ``load_torch_state_dict``
reads its three file forms, and ``convert`` refuses a method it has no
converter for before it reads the file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cd_parity as cdp
import torch_ref_layout as ref
from kurosiwo_torch import convert as tconv
from kurosiwo_torch.convert import flax_to_torch
from kurosiwo_torch.models import factory as tfac
from kurosiwo_tpu import convert as jconv
from kurosiwo_tpu.models import factory as jfac
from kurosiwo_tpu.models.resnet import ResNetEncoder

SEG = {"task": "segmentation", "num_classes": 3, "mixed_precision": False}
VIT = {"image_size": 32, "finetuning_patch_size": 16, "dim": 32, "depth": 2, "heads": 2,
       "mlp_dim": 64, "synthetic_patch_size": 32}
TU = {"out_channels": 16, "head_num": 2, "mlp_dim": 32, "block_num": 2}
UPER_CHANNELS = 32


def _cd(method: str, side: int, mcfg: dict):
    cfg = dict(cdp.config(method), synthetic_patch_size=side)
    shapes = ref.cd_shapes(jfac.initialize_cd_model(cfg, mcfg), side)
    return shapes, lambda: tfac.initialize_cd_model(cfg, mcfg, device="cpu")


def _seg(method: str, channels: int, side: int, mcfg: dict, **kw):
    cfg = dict(SEG, method=method, num_channels=channels, **kw)
    shapes = ref.jax_shapes(jfac.initialize_segmentation_model(cfg, mcfg),
                            jnp.zeros((1, side, side, channels)), train=False)
    return shapes, lambda: tfac.initialize_segmentation_model(cfg, mcfg, device="cpu")


def _upernet(family: str):
    os.environ.setdefault("USE_TF", "0")  # transformers' TensorFlow import alone takes ~7 s
    transformers = pytest.importorskip(
        "transformers", reason="the UperNet fixtures are transformers models")
    from kurosiwo_torch.models import upernet as tup
    from kurosiwo_tpu.models import upernet as jup

    if family == "convnext":
        spec, side = ((1, 1, 2, 1), (16, 32, 64, 128)), 64
        bc = transformers.ConvNextConfig(num_channels=2, hidden_sizes=[16, 32, 64, 128],
                                         depths=[1, 1, 2, 1],
                                         out_features=["stage1", "stage2", "stage3", "stage4"])
    else:
        spec, side = ((1, 1, 2, 1), 16, (1, 2, 4, 8)), 224
        bc = transformers.SwinConfig(num_channels=2, embed_dim=16, depths=[1, 1, 2, 1],
                                     num_heads=[1, 2, 4, 8], window_size=7, image_size=224,
                                     out_features=["stage1", "stage2", "stage3", "stage4"])
    torch.manual_seed(0)
    tm = transformers.UperNetForSemanticSegmentation(
        transformers.UperNetConfig(backbone_config=bc, hidden_size=UPER_CHANNELS, num_labels=3))
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    jm = jup.UperNet(num_classes=3, backbone=f"{family}_custom", channels=UPER_CHANNELS,
                     dtype=jnp.float32, backbone_spec=spec)
    shapes = ref.jax_shapes(jm, jnp.zeros((1, side, side, 2)), train=False)
    port = lambda: tup.UperNet(2, 3, f"{family}_custom", channels=UPER_CHANNELS,
                               backbone_spec=spec, image_size=side)
    return sd, shapes, port, jm


def _vit(pool: str):
    from kurosiwo_torch.models.vit import ViT as TViT
    from kurosiwo_tpu.models.vit import ViT as JViT

    kw = dict(image_size=32, patch_size=16, num_classes=5, dim=32, depth=2, heads=2,
              mlp_dim=64, channels=6, pool=pool)
    shapes = ref.jax_shapes(JViT(dtype=jnp.float32, **kw), jnp.zeros((1, 32, 32, 6)))
    return shapes, lambda: TViT(**kw)


def build(case: str, seed: int = 0):
    """(converter key, reference-layout state_dict, the JAX model's init
    shapes, a function that builds the port's model) of one case."""
    if case.startswith("finetune"):
        head = case.split("-")[1]
        shapes, port = _seg("finetune", 6, 32, {}, **VIT,
                            **({head: True} if head != "linear" else {}))
        return "finetune", ref.reference_state(shapes, ref.FINETUNE, seed), shapes, port
    if case in ("floodvit", "vit"):
        shapes, port = _vit("mean" if case == "floodvit" else "cls")
        return case, ref.reference_state(shapes, ref.FLOODVIT, seed), shapes, port
    if case == "unet":
        shapes, port = _seg("unet", 6, 64, {"backbone": "resnet18"})
        return case, ref.reference_state(shapes, ref.SMP_UNET, seed), shapes, port
    if case.startswith("upernet"):
        sd, shapes, port, _ = _upernet(case.split("-")[1])
        return "upernet", sd, shapes, port
    if case == "convlstm":
        from kurosiwo_tpu.models.convlstm import ConvLSTM

        shapes = ref.jax_shapes(ConvLSTM(num_classes=3, dtype=jnp.float32),
                                jnp.zeros((1, 3, 32, 32, 2)), train=False)
        cfg = {"method": "convlstm", "num_classes": 3, "num_channels": 2,
               "mixed_precision": False}
        return case, ref.reference_state(shapes, ref.CONVLSTM, seed, extra=ref.CONVLSTM_DEAD), \
            shapes, lambda: tfac.initialize_recurrent_model(cfg, {}, device="cpu")
    method, side, mcfg, rules, kw = {
        "snunet": ("snunet", 32, {"base_channel": 8}, ref.SNUNET, {}),
        "siam-diff": ("siam-diff", 32, {}, ref.SIAM, {}),
        "siam-conc": ("siam-conc", 32, {}, ref.SIAM, {}),
        "bit-cd": ("bit-cd", 32, {}, ref.BIT, {}),
        "bit-cd-transformer": ("bit-cd", 32, {"net_G": "base_transformer_pos_s4_dd8"},
                               ref.BIT_TRANSFORMER, {}),
        "changeformer": ("changeformer", 32, {"embed_dim": 32}, ref.CHANGEFORMER, {}),
        "transunet-cd": ("transunet-cd", 32, TU, ref.TRANSUNET, {"conv_bias": True}),
        "transunet-cd-siamese": ("transunet-cd", 32, dict(TU, siamese=True), ref.TRANSUNET,
                                 {"conv_bias": True}),
        "hfa-net": ("hfa-net", 224, {}, ref.HFANET, {}),
        "adhr-cdnet": ("adhr-cdnet", 32, {}, ref.ADHR, {"extra": ref.ADHR_DEAD}),
    }[case]
    shapes, port = _cd(method, side, mcfg)
    key = case.replace("-siamese", "")
    return key, ref.reference_state(shapes, rules, seed, **kw), shapes, port


CASES = ["finetune-mlp", "finetune-decoder", "finetune-linear", "snunet", "floodvit", "vit",
         "siam-diff", "siam-conc", "bit-cd", "bit-cd-transformer", "convlstm", "changeformer",
         "transunet-cd", "transunet-cd-siamese", "hfa-net", "adhr-cdnet", "upernet-convnext",
         "upernet-swin", "unet"]
_BUILT: dict = {}


@pytest.fixture(params=CASES)
def case(request):
    if request.param not in _BUILT:
        key, sd, shapes, port = build(request.param)
        _BUILT[request.param] = {"key": key, "sd": sd, "shapes": shapes, "port": port,
                                 "jax": jconv.CONVERTERS[key](sd)}
    return _BUILT[request.param]


def _tree_shapes(variables: dict) -> dict:
    return {(coll,) + tuple(k.key for k in path): tuple(np.shape(leaf))
            for coll in ("params", "batch_stats")
            for path, leaf in jax.tree_util.tree_flatten_with_path(variables.get(coll, {}))[0]}


def assert_bit_exact(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))[:8]
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_fixture_has_the_jax_models_init_structure(case):
    assert _tree_shapes(case["jax"]) == case["shapes"]


def test_port_converter_is_flax_to_torch_of_jax_converter(case):
    assert tconv.CONVERTERS is not jconv.CONVERTERS
    assert sorted(tconv.CONVERTERS) == sorted(jconv.CONVERTERS)
    assert_bit_exact(tconv.CONVERTERS[case["key"]](case["sd"]), flax_to_torch(case["jax"]))


def test_converted_state_loads_into_the_port_model(case):
    model = case["port"]()
    state = tconv.CONVERTERS[case["key"]](case["sd"])
    params = dict(model.named_parameters())
    assert set(params) <= set(state)  # every parameter from the file
    tconv.load_into(model, state)
    for k, v in model.state_dict().items():
        if k in state:
            assert torch.equal(v, state[k]), k


# ------------------------------------------------- torchvision ResNet + graft


def _torchvision(backbone: str, seed: int, width: int = 64):
    shapes = ref.jax_shapes(ResNetEncoder(backbone, width=width, dtype=jnp.float32),
                            jnp.zeros((1, 32, 32, 3)), train=False)
    sd = ref.reference_state(shapes, ref.resnet_rules(bottleneck=backbone == "resnet50"), seed)
    return sd, shapes


@pytest.mark.parametrize("channels", [3, 6])
def test_torchvision_resnet_graft_matches_jax(channels):
    """The encoder of a 3-channel torchvision resnet18 file, grafted into a
    UNet of ``channels`` inputs: bit-exact with JAX's graft on the same
    initial tree (the stem, its affine and its statistics grafted at 3
    channels, kept at 6)."""
    sd, enc_shapes = _torchvision("resnet18", 1)
    jenc = jconv.convert_torchvision_resnet(sd)
    assert _tree_shapes(jenc) == enc_shapes
    tenc = tconv.convert_torchvision_resnet(sd)
    assert_bit_exact(tenc, flax_to_torch(jenc))

    cfg = dict(SEG, method="unet", num_channels=channels)
    shapes = ref.jax_shapes(jfac.initialize_segmentation_model(cfg, {"backbone": "resnet18"}),
                            jnp.zeros((1, 64, 64, channels)), train=False)
    rs = np.random.RandomState(2)  # any seeded tree of the model's shapes
    v0 = {"params": {}, "batch_stats": {}}
    for (coll, *path, leaf), shape in sorted(shapes.items()):
        node = v0[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = rs.randn(*shape).astype(np.float32)
    want = flax_to_torch(jconv.graft_encoder(v0, jenc))
    got = tconv.graft_encoder(flax_to_torch(v0), tenc)
    assert_bit_exact(got, want)
    for name in ("stem.Conv_0.weight", "stem.BatchNorm_0.scale", "stem.BatchNorm_0.mean"):
        assert torch.equal(got[f"encoder.{name}"], tenc[name]) == (channels == 3), name
    model = tfac.initialize_segmentation_model(cfg, {"backbone": "resnet18"}, device="cpu")
    tconv.load_into(model, got)
    assert torch.equal(model.encoder.layer4_1.ConvBNAct_0.Conv_0.weight,
                       tenc["layer4_1.ConvBNAct_0.Conv_0.weight"])


def test_torchvision_bottleneck_resnet_matches_jax():
    """resnet50's Bottleneck blocks: conv1..conv3, the downsample at
    ConvBNAct_3; loads into the port's ResNetEncoder (both at width 16)."""
    from kurosiwo_torch.models.resnet import ResNetEncoder as TEncoder

    sd, shapes = _torchvision("resnet50", 4, width=16)
    jenc = jconv.convert_torchvision_resnet(sd)
    assert _tree_shapes(jenc) == shapes
    tenc = tconv.convert_torchvision_resnet(sd)
    assert_bit_exact(tenc, flax_to_torch(jenc))
    assert "layer1_0.ConvBNAct_3.Conv_0.weight" in tenc
    tconv.load_into(TEncoder(3, "resnet50", width=16), tenc)


def test_graft_refuses_an_encoder_that_does_not_match():
    sd, _ = _torchvision("resnet18", 3)
    state = {f"encoder.{k}": v for k, v in tconv.convert_torchvision_resnet(sd).items()}
    del sd["layer2.0.downsample.0.weight"], sd["layer2.0.downsample.1.weight"]
    with pytest.raises(KeyError, match="layer2_0"):
        tconv.graft_encoder(state, tconv.convert_torchvision_resnet(sd))


# ----------------------------------------------------------- one forward each


def _forward_pair(case_name: str, jmodel, xs_nhwc, port_call, atol):
    key, sd, _, port = build(case_name, seed=5)
    variables = jax.tree.map(np.asarray, jconv.CONVERTERS[key](sd))
    want = np.asarray(cdp.jit_fast(lambda v, *xs: jmodel.apply(v, *xs, train=False),
                                   variables, *[jnp.asarray(x) for x in xs_nhwc]))
    model = port()
    tconv.load_into(model, tconv.CONVERTERS[key](sd))
    model.eval()
    with torch.no_grad():
        got = port_call(model, *[torch.from_numpy(x) for x in xs_nhwc]).float().numpy()
    np.testing.assert_allclose(got, want, atol=atol)


def test_unet_forward_with_converted_weights_matches_jax():
    cfg = dict(SEG, method="unet", num_channels=6)
    x = np.random.RandomState(0).randn(2, 64, 64, 6).astype(np.float32)
    _forward_pair("unet", jfac.initialize_segmentation_model(cfg, {"backbone": "resnet18"}),
                  [x], lambda m, x: m(x), 5e-4)


def test_snunet_forward_with_converted_weights_matches_jax():
    xa, xb = cdp.frames("snunet", seed=3)
    _forward_pair("snunet", jfac.initialize_cd_model(cdp.config("snunet"), {"base_channel": 8}),
                  [xa, xb], lambda m, a, b: m(a, b), 5e-4)


def test_upernet_forward_with_converted_weights_matches_jax():
    _, _, _, jm = _upernet("convnext")
    x = np.random.RandomState(1).randn(1, 64, 64, 2).astype(np.float32)
    _forward_pair("upernet-convnext", jm, [x], lambda m, x: m(x), 1e-3)


# ------------------------------------------------------------ the file forms


@pytest.mark.parametrize("form", ["state_dict", "model_state_dict", "module"])
def test_load_torch_state_dict_reads_each_file_form(tmp_path, form):
    key, sd, _, _ = build("snunet", seed=7)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    obj = {"state_dict": tensors, "model_state_dict": {"model_state_dict": tensors, "epoch": 3},
           "module": ref.RefModule(sd)}[form]
    path = tmp_path / "best_segmentation.pt"
    torch.save(obj, path)
    got = tconv.load_torch_state_dict(path)
    assert sorted(got) == sorted(jconv.load_torch_state_dict(str(path))) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v)
    assert_bit_exact(tconv.convert(path, key), flax_to_torch(jconv.convert(str(path), key)))


def test_convert_refuses_an_unknown_method_before_reading(tmp_path):
    path = tmp_path / "not_a_checkpoint.pt"
    path.write_bytes(b"not a pickle")
    with pytest.raises(KeyError, match="no converter for 'unet\\+\\+'"):
        tconv.convert(path, "unet++")
