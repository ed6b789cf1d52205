"""Seeded state_dicts in the reference's key layout, for the converter
tests (tests/test_torch_convert.py, tests/test_torch_parity_harness.py).

Each is written from a JAX model's parameter shapes (``jax.eval_shape`` of
its ``init``: no compile) by this module's own rename rules, from the
model's flax module path to the reference module's key, following the key
patterns ``kurosiwo_tpu/convert.py`` reads (torchvision's ResNet, smp's
UNet, the reference's SNUNet, Siam, BiT, ConvLSTM, TransUNet, HFA-Net,
ChangeFormer, ADHR and FloodViT modules): conv and transposed-conv weights
OIHW / IOHW, Linear (out, in), BatchNorm's weight, bias, running_mean,
running_var and num_batches_tracked, LayerNorm's and GroupNorm's weight and
bias, PReLU's weight. The few parameters the reference builds and never
uses (ADHR's convf2, the ConvLSTM's transconv_1d/2d) are written too, for
the converters to skip; TransUNet's convs carry the bias its converter
folds into BatchNorm's mean. The tests hold the JAX converter's tree on
each to the JAX model's own init tree: that shows a fixture right without
the port. UperNet's come from ``transformers`` models instead (the tests).

``RefModule`` holds such a state_dict as a module tree, for the
whole-module pickle form of ``load_torch_state_dict`` (the reference's
``torch.save(model)``); it lives here so that ``torch.load`` finds its
class by import.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

# flax leaf -> the reference parameter's suffix
_LEAF = {("params", "kernel"): "weight", ("params", "bias"): "bias",
         ("params", "scale"): "weight", ("params", "alpha"): "weight",
         ("batch_stats", "mean"): "running_mean", ("batch_stats", "var"): "running_var"}


def jax_shapes(model, *inputs, **kw) -> dict[tuple, tuple]:
    """{(collection, *path, leaf): shape} of ``model.init``'s tree."""
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *inputs, **kw))
    out = {}
    for coll, sub in tree.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(sub)[0]:
            out[(coll,) + tuple(k.key for k in path)] = tuple(leaf.shape)
    return out


def torch_shape(shape: tuple) -> tuple:
    """A flax kernel's shape in torch's layout (HWIO -> OIHW, HWOI -> IOHW,
    (in, out) -> (out, in))."""
    return (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape[::-1]


def _rename(rules, path: str) -> str:
    for pattern, repl in rules:
        m = re.fullmatch(pattern, path)
        if m:
            return repl(m) if callable(repl) else m.expand(repl)
    raise KeyError(f"no reference name for {path!r}")


def reference_state(shapes: dict, rules, seed: int, conv_bias: bool = False,
                    extra: dict | None = None) -> dict[str, np.ndarray]:
    """The reference-layout state_dict of a model whose flax tree has
    ``shapes``: each module path renamed by ``rules`` ((regex, replacement)
    pairs, the first full match wins; a leaf outside _LEAF is renamed with
    its path), seeded values (weights N / sqrt(fan-in), biases 0.05 N, norm scales
    1 + 0.2 N, PReLU 0.25 + 0.05 N, means 0.1 N, variances 0.5 + U).
    ``conv_bias`` gives every ``Conv_0`` without a bias one; ``extra``
    adds {key: shape} entries."""
    rs = np.random.RandomState(seed)
    sd: dict[str, np.ndarray] = {}
    for (coll, *path, leaf), shape in sorted(shapes.items()):
        if (coll, leaf) in _LEAF:
            key = f"{_rename(rules, '/'.join(path))}.{_LEAF[coll, leaf]}"
        else:
            key = _rename(rules, "/".join(path + [leaf]))
        if leaf == "kernel":  # fan-in scaled, so a deep eval forward stays O(1)
            t = torch_shape(shape)
            value = rs.randn(*t) / np.sqrt(np.prod(t[1:]))
        elif leaf == "scale":
            value = 1.0 + 0.2 * rs.randn(*shape)
        elif leaf == "alpha":
            value = 0.25 + 0.05 * rs.randn(*shape)
        elif leaf == "var":
            value = 0.5 + rs.rand(*shape)
            sd[key.replace("running_var", "num_batches_tracked")] = np.asarray(7, np.int64)
        else:
            value = (0.05 if leaf == "bias" else 0.1) * rs.randn(*shape)
        sd[key] = value.astype(np.float32)
        if conv_bias and path[-1] == "Conv_0" and leaf == "kernel" and (
                (coll, *path, "bias") not in shapes):
            sd[key.replace(".weight", ".bias")] = (0.05 * rs.randn(shape[-1])).astype(np.float32)
    for key, shape in (extra or {}).items():
        sd[key] = (0.1 * rs.randn(*shape)).astype(np.float32)
    return sd


def _dots(m) -> str:
    return m[0].replace("/", ".")


def resnet_rules(ours: str = "", theirs: str = "", bottleneck: bool = False) -> list:
    """torchvision's ResNet under ``theirs`` for the flax ResNetEncoder
    under ``ours``: the stem's conv1/bn1, a block's convs conv1..conv{n}
    and its downsample (the block's last ConvBNAct)."""
    ds = 3 if bottleneck else 2

    def block(m):
        c = int(m[3])
        kind = ("downsample.0" if m[4] == "Conv_0" else "downsample.1") if c == ds else (
            f"conv{c + 1}" if m[4] == "Conv_0" else f"bn{c + 1}")
        return f"{theirs}layer{m[1]}.{m[2]}.{kind}"

    return [(rf"{ours}stem/Conv_0", f"{theirs}conv1"),
            (rf"{ours}stem/BatchNorm_0", f"{theirs}bn1"),
            (rf"{ours}layer(\d)_(\d+)/ConvBNAct_(\d)/(Conv_0|BatchNorm_0)", block)]


SMP_UNET = resnet_rules("encoder/", "encoder.") + [
    (r"DecoderBlock_(\d)/ConvBNAct_(\d)/(Conv_0|BatchNorm_0)",
     lambda m: f"decoder.blocks.{m[1]}.conv{int(m[2]) + 1}.{0 if m[3] == 'Conv_0' else 1}"),
    (r"head", "segmentation_head.0"),
]

SNUNET = [(r".*", _dots)]  # the reference's own names


def _siam_dec(m) -> str:
    s, k = int(m[1]), int(m[2])
    return f"{'conv' if m[3] == 'conv' else 'bn'}{s}{(3 if s >= 3 else 2) - k}d"


SIAM = [(r"encoder/c(\d\d)/conv", r"conv\1"), (r"encoder/c(\d\d)/bn", r"bn\1"),
        (r"upconv\d", _dots), (r"dec(\d)_(\d)/(conv|bn)", _siam_dec),
        (r"classifier", "conv11d")]

BIT = resnet_rules("backbone/resnet/", "resnet.") + [
    (r"backbone/conv_pred", "conv_pred"),
    (r"classifier/ConvBNAct_0/Conv_0", "classifier.0"),
    (r"classifier/ConvBNAct_0/BatchNorm_0", "classifier.1"),
    (r"classifier/Conv_0", "classifier.3"),
]


def _bit_token(m) -> str:
    part, kind, i, rest = m[1], m[2], m[3], m[4]
    if kind == "norm_attn":
        return f"{part}.layers.{i}.0.fn.norm"
    if kind == "norm_ff":
        return f"{part}.layers.{i}.1.fn.norm"
    if kind == "attn":
        return f"{part}.layers.{i}.0.fn.fn.{rest[1:]}" + (".0" if rest == "/to_out" else "")
    return f"{part}.layers.{i}.1.fn.fn.net.{0 if rest == '/Dense_0' else 3}"


BIT_TRANSFORMER = BIT + [
    (r"pos_embedding", "pos_embedding"), (r"conv_a", "conv_a"),
    (r"(transformer|transformer_decoder)/(norm_attn|norm_ff|attn|ff)_(\d+)(/\w+)?", _bit_token),
]

CONVLSTM = [(r"conv_\de|transconv_3d", _dots), (r"(clstm_\d[ed])/conv", r"\1.conv.0"),
            (r"(clstm_\d[ed])/norm", r"\1.conv.1")]
CONVLSTM_DEAD = {"transconv_1d.weight": (256, 3, 4, 4), "transconv_2d.weight": (128, 3, 4, 4)}


def vit_rules(ours: str = "", theirs: str = "") -> list:
    return [(rf"{ours}patch_norm1", f"{theirs}to_patch_embedding.1"),
            (rf"{ours}patch_proj", f"{theirs}to_patch_embedding.2"),
            (rf"{ours}patch_norm2", f"{theirs}to_patch_embedding.3"),
            (rf"{ours}(pos_embedding|cls_token|mlp_head)", rf"{theirs}\1"),
            (rf"{ours}transformer/attn_(\d+)/norm", rf"{theirs}transformer.layers.\1.0.norm"),
            (rf"{ours}transformer/attn_(\d+)/to_qkv", rf"{theirs}transformer.layers.\1.0.to_qkv"),
            (rf"{ours}transformer/attn_(\d+)/to_out", rf"{theirs}transformer.layers.\1.0.to_out.0"),
            (rf"{ours}transformer/ff_(\d+)/norm", rf"{theirs}transformer.layers.\1.1.net.0"),
            (rf"{ours}transformer/ff_(\d+)/fc1", rf"{theirs}transformer.layers.\1.1.net.1"),
            (rf"{ours}transformer/ff_(\d+)/fc2", rf"{theirs}transformer.layers.\1.1.net.4"),
            (rf"{ours}transformer/norm", f"{theirs}transformer.norm")]


FLOODVIT = vit_rules()
FINETUNE = vit_rules("encoder/", "model.") + [
    (r"head_fc1", "head.0"), (r"head_fc2", "head.2"), (r"head_fc", "head"),
    (r"head/(deconv\d)", r"head.\1")]


def _tu_conv(m) -> str:
    enc, inner, kind = m[1], m[2], m[3]
    if inner.startswith("encoder"):
        blk, conv = inner.split("/")
        if conv == "downsample":
            return f"{enc}.{blk}.downsample.{0 if kind == 'Conv_0' else 1}"
        return f"{enc}.{blk}.{conv if kind == 'Conv_0' else conv.replace('conv', 'norm')}"
    return f"{enc}.{inner if kind == 'Conv_0' else inner.replace('conv', 'norm')}"


_TU_BLOCK = {"qkv": "multi_head_attention.qkv_layer",
             "out_attention": "multi_head_attention.out_attention",
             "norm1": "layer_norm1", "norm2": "layer_norm2", "fc1": "mlp.mlp_layers.0",
             "fc2": "mlp.mlp_layers.3"}

TRANSUNET = [
    (r"(encoder\d?)/(conv\d|encoder\d/conv\d|encoder\d/downsample)/(Conv_0|BatchNorm_0)",
     _tu_conv),
    (r"(encoder\d?)/vit/(projection|embedding|cls_token)", r"\1.vit.\2"),
    (r"(encoder\d?)/vit/block_(\d+)/(\w+)",
     lambda m: f"{m[1]}.vit.transformer.layer_blocks.{m[2]}.{_TU_BLOCK[m[3]]}"),
    (r"decoder(\d)/conv(\d)/(Conv_0|BatchNorm_0)",
     lambda m: f"decoder.decoder{m[1]}.layer."
               f"{3 * (int(m[2]) - 1) + (0 if m[3] == 'Conv_0' else 1)}"),
    (r"head", "decoder.conv1"),
]

_HFA_SA = ["1_1", "1_2", "2_1", "2_2", "_b_1", "_b_2", "3_1", "3_2", "4_1", "4_2", "5_1"]
_CBP = {"Conv_0": 0, "BatchNorm_0": 1, "PReLU_0": 2}


def _hfab(rest: str) -> str:
    m = re.fullmatch(r"sa/ConvBNPReLU_(\d+)/(\w+)", rest)
    if m:
        x = _HFA_SA[int(m[1])]
        return "SA." + {"Conv_0": "conv", "BatchNorm_0": "bn", "PReLU_0": "ReLU"}[m[2]] + x
    return {"sa/TorchConvTranspose_0": "SA.convtrans_1", "sa/TorchConvTranspose_1": "SA.convtrans_2",
            "sa/Conv_0": "SA.conv5_2", "sa/BatchNorm_0": "SA.bn5_2", "hf/fc1": "HF.FC_1",
            "hf/PReLU_0": "HF.ReLU", "hf/fc2": "HF.FC_2", "hf/fusion": "HF.Channelfusion"}[rest]


def _hfa_layer(seq: str, part: str, rest: str) -> str:
    """A Sequential of two (HFAB, Conv, BN, PReLU) groups (the encoder's
    _layer_i), or of two (Conv, BN, PReLU, HFAB) groups (the decoder's
    _up_layer_i)."""
    base = 4 if part.endswith("2") else 0
    if seq.startswith("encoder"):
        if part.startswith("hfab"):
            return f"{seq}.{base}.{_hfab(rest)}"
        return f"{seq}.{base + 1 + _CBP[rest]}"
    if part.startswith("hfab"):
        return f"{seq}.{base + 3}.{_hfab(rest)}"
    return f"{seq}.{base + _CBP[rest]}"


HFANET = [
    (r"encoder/pre_treat", "encoder._pre_treat_2"),
    (r"encoder/layer_(\d)/(hfab\d|conv\d)/(.+)",
     lambda m: _hfa_layer(f"encoder._layer_{m[1]}", m[2], m[3])),
    (r"skip_fusion_(\d)", r"skip_connection_feature_fusion_\1"),
    (r"bottom_fusion", "bottom_feature_fusion"),
    (r"up_(\d)/reduce", r"decoder._up_sample_\1.0"),
    (r"up_(\d)/(hfab\d|conv\d)/(.+)",
     lambda m: _hfa_layer(f"decoder._up_layer_{m[1]}", m[2], m[3])),
    (r"out(\d)/(\w+)",
     lambda m: f"decoder._out_layer.{3 * (int(m[1]) - 1) + _CBP[m[2]]}"),
    (r"head", "decoder._out_layer.6"),
]


def _cf_block(m) -> str:
    s, i, rest = m[1], m[2], m[3].replace("/", ".")
    return f"Tenc_x2.block{s}.{i}.{'mlp.dwconv.dwconv' if rest == 'mlp.dwconv' else rest}"


CHANGEFORMER = [
    (r"Tenc_x2/(patch_embed\d/(proj|norm)|norm\d)", _dots),
    (r"Tenc_x2/block(\d)_(\d+)/(.+)", _cf_block),
    (r"TDec_x2/linear_c(\d)", r"TDec_x2.linear_c\1.proj"),
    (r"TDec_x2/(diff_c\d|make_pred_c\d)/(\w+)",
     lambda m: f"TDec_x2.{m[1]}.{ {'Conv_0': 0, 'BatchNorm_0': 2, 'Conv_1': 3}[m[2]] }"),
    (r"TDec_x2/linear_fuse", "TDec_x2.linear_fuse.0"),
    (r"TDec_x2/fuse_bn", "TDec_x2.linear_fuse.1"),
    (r"TDec_x2/(convd2x|convd1x|change_probability)", r"TDec_x2.\1.conv2d"),
    (r"TDec_x2/(dense_\dx)/(conv\d)", r"TDec_x2.\1.0.\2.conv2d"),
]

_ADHR_CHAIN = {"1to3": 2, "1to4": 3, "2to4": 2}


def _adhr_pair(m) -> str:
    k, kind = int(m[2]), "conv" if m[3] == "Conv_0" else "bn"
    return f"{m[1].replace('/', '.')}.{kind}{k + 1}"


def _adhr_down(m) -> str:
    s, link, i, kind = m[1], m[2], int(m[3]), "conv" if m[4] == "Conv_0" else "bn"
    return (f"{kind}{s}_{link}_{i + 1}" if _ADHR_CHAIN.get(link, 1) > 1 else f"{kind}{s}_{link}")


ADHR = [
    (r"conv0_0|conv0|bn0|c\d|attention\d|final|conv1_1_1/(conv3|conv1_1|bn3)", _dots),
    (r"stage(\d)_b(\d)/b(\d)/_ConvBN_(\d)/(Conv_0|BatchNorm_0)",
     lambda m: f"conv{m[1]}_{m[2]}_{m[3]}.{'conv' if m[5] == 'Conv_0' else 'bn'}"
               f"{int(m[4]) + 1}"),
    (r"t(\d)_(\dto\d)/_ConvBN_0/(Conv_0|BatchNorm_0)",
     lambda m: f"{'conv' if m[3] == 'Conv_0' else 'bn'}{m[1]}_{m[2]}"),
    (r"t(\d)_(\dto\d)/d(\d)/(Conv_0|BatchNorm_0)", _adhr_down),
    (r"trans1_(\d)/(Conv_0|BatchNorm_0)",
     lambda m: f"{'conv' if m[2] == 'Conv_0' else 'bn'}1_{m[1]}"),
    (r"f(\d)/_ConvBN_0/(Conv_0|BatchNorm_0)",
     lambda m: f"{'conv' if m[2] == 'Conv_0' else 'bn'}{m[1]}f"),
    (r"(conv1_1_\d|conv\d)/_ConvBN_(\d)/(Conv_0|BatchNorm_0)", _adhr_pair),
]
ADHR_DEAD = {"convf2.weight": (64, 64, 3, 3), "bnf2.weight": (64,),
             "conv4_1to2.weight": (64, 32, 3, 3)}


def cd_shapes(model, side: int) -> dict:
    x = jnp.zeros((1, side, side, 2))
    return jax_shapes(model, x, x, train=False)


class RefModule(torch.nn.Module):
    """A module tree whose ``state_dict`` is ``state`` (reference-layout
    keys), to pickle whole as the reference saves its best model."""

    def __init__(self, state: dict[str, np.ndarray]):
        super().__init__()
        for key, value in state.items():
            *path, name = key.split(".")
            mod = self
            for p in path:
                if p not in mod._modules:
                    mod.add_module(p, torch.nn.Module())
                mod = mod._modules[p]
            t = torch.from_numpy(np.array(value))
            if t.is_floating_point():
                mod.register_parameter(name, torch.nn.Parameter(t, requires_grad=False))
            else:
                mod.register_buffer(name, t)
