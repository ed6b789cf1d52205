"""Weights for the port's models: the parameter bridge between a flax
model's variables and the port's ``state_dict``, and the converters from
the reference's torch checkpoints (counterpart of ``kurosiwo_tpu/convert.py``).

The bridge (:func:`flax_to_torch`, :func:`torch_to_flax`) covers every
segmentation tree (UNet, UNet++, DeepLabV3+ on the BasicBlock and
Bottleneck ResNets, UperNet on ConvNeXt and Swin, the FloodViT finetuner
with its three heads), the MAE/ViT (and the encoder alone, MAE's
``vit_{e}``), the recurrent ConvLSTM, the diffusion task's DDPM and the
eight change-detection trees.

The port names its submodules after the flax paths (``encoder.stem.Conv_0``,
``encoder.layer1_0.ConvBNAct_0.BatchNorm_0``, ``DecoderBlock_4.ConvBNAct_1``,
``head``; ``dec_1_2``, ``final_block``; the flax auto-names ``ASPP_0`` and
its ``ConvBNAct_0``-``ConvBNAct_5``; ``backbone.stage2_block4.dwconv``,
``decode_head.psp.branch3``, ``decode_head.fpn_bottleneck``;
``backbone.stage0_block1.attn.qkv``, ``merge2``; ``encoder.transformer.attn_3.to_qkv``,
``decoder.ff_0.fc1``, ``enc_to_dec``, ``decoder_pos_emb``, ``to_pixels``,
``head_fc1``, ``head.deconv2``; ``clstm_1e.conv``, ``clstm_1e.norm``,
``transconv_3d``; ``model.Dense_0``, ``model.ResnetBlock_3.GroupNorm_1``,
``model.LinearAttention_0.Conv_0``), so the map is a path join plus
layout transposes (the DDPM needed no rule of its own):

  params/.../kernel (HWIO, conv)  <-> ....weight (OIHW): the 7x7 stem, the
                                      4x4/s4 and 2x2/s2 patchify convs; a
                                      depthwise kernel (HWIO with I = 1,
                                      ChangeFormer's and ConvNeXt's
                                      ``dwconv``) is the grouped (C, 1, k, k)
  params/.../kernel (HWOI, the transposed convs' torch layout)
                                  <-> ....weight (IOHW, F.conv_transpose2d's;
                                      Siam's ``up``, the finetuner's
                                      ``deconv1``-``deconv3``, the
                                      ConvLSTM's ``transconv_3d``)
  params/.../kernel (in, out)     <-> ....weight (out, in)   (Dense; Swin's
                                      bias-free ``merge{s}`` has no bias)
  params/.../{bias, scale (LayerNorm, GroupNorm), alpha, gamma,
              relative_position_bias, embedding,
              pos_embedding, cls_token, mask_token}
                                  <-> the same name, as it is
  batch_stats/.../{mean, var}     <-> ....{mean, var}   (buffers)

Inputs and outputs are numpy arrays (or anything ``np.asarray`` takes);
the transposes are exact, so a round trip is bit-exact.

The converters map a reference state_dict (numpy arrays, torch's layouts)
straight to the port's ``state_dict``. Conv (OIHW), transposed-conv (IOHW)
and Linear (out, in) weights keep their torch layout, so most entries are
renames; beyond them:

  BatchNorm2d        weight, bias, running_mean, running_var
                                  -> scale, bias, mean, var
  LayerNorm, GroupNorm weight     -> scale
  PReLU              weight       -> alpha
  Conv(+bias) -> BN onto a bias-free ConvBNAct (TransUNet-CD): the bias
                     folded into the mean, mean - bias in the file's dtype
  Swin (HF)          query/key/value concatenated into qkv; patch merging's
                     input groups permuted from HF's (00, 10, 01, 11) to the
                     model's row-major (00, 01, 10, 11), on the reduction's
                     dim 1 and its norm's scale and bias

Each output is the bridge's image of the JAX converter's on the same file,
bit for bit. :func:`load_into` copies one into a model's own tensors.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

_STATS = ("mean", "var")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def flax_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} -> state_dict of the port's model."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})).items():
            arr = np.asarray(leaf)
            name = path[-1]
            if name == "kernel":
                arr, name = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T), "weight"
            state[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(arr, order="C"))
    return state


def torch_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, dict]:
    """Inverse of :func:`flax_to_torch`: nested dicts of numpy arrays."""
    out: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        *path, name = key.split(".")
        arr = tensor.detach().cpu().numpy()
        if name == "weight":
            arr, name = (arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T), "kernel"
        node = out["batch_stats" if name in _STATS else "params"]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return out


# ---------------------------------------------------------------------------
# the file, the layout helpers, loading into a model
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """A torch checkpoint's tensors as numpy arrays: a raw state_dict, a
    trainer's ``{"model_state_dict": ...}`` wrapper, or a whole pickled
    module (the reference saves its best model so; ``weights_only=False``,
    so load only files you trust)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    elif isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "detach")}


def _tensors(out: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def _convert_conv(out: dict, name: str, sd, key: str) -> None:
    """Conv2d, ConvTranspose2d and Linear alike: the port keeps torch's
    layout of each, so weight and bias are copied as they are."""
    out[f"{name}.weight"] = sd[f"{key}.weight"]
    if f"{key}.bias" in sd:
        out[f"{name}.bias"] = sd[f"{key}.bias"]


_convert_tconv = _convert_dense = _convert_conv


def _convert_bn(out: dict, name: str, sd, key: str) -> None:
    out[f"{name}.scale"] = sd[f"{key}.weight"]
    out[f"{name}.bias"] = sd[f"{key}.bias"]
    out[f"{name}.mean"] = sd[f"{key}.running_mean"]
    out[f"{name}.var"] = sd[f"{key}.running_var"]


def _convert_ln(out: dict, name: str, sd, key: str) -> None:
    out[f"{name}.scale"] = sd[f"{key}.weight"]
    out[f"{name}.bias"] = sd[f"{key}.bias"]


_convert_gn = _convert_ln


def with_statistics(state: Mapping[str, torch.Tensor],
                    own: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``state``, with ``own``'s BatchNorm statistics where ``state`` has
    none at all (FloodViT, the finetuner, the ConvLSTM), as the JAX engine
    keeps its initialised ``batch_stats`` then."""
    if any(k.rsplit(".", 1)[-1] in _STATS for k in state):
        return dict(state)
    return {**{k: v for k, v in own.items() if k.rsplit(".", 1)[-1] in _STATS}, **state}


def load_into(model: torch.nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Copy a converted ``state`` into ``model``'s own parameters and
    buffers (``load_state_dict``: in place, under no_grad, so an optimizer
    that holds the parameters steps the loaded values). Strict: every
    parameter must come from ``state``; the statistics as
    :func:`with_statistics`."""
    model.load_state_dict(with_statistics(state, model.state_dict()))


# ---------------------------------------------------------------------------
# SNUNet-ECAM (reference models/snunet.py)
# ---------------------------------------------------------------------------

def convert_snunet(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    out: dict = {}
    blocks = [k.split(".")[0] for k in sd.keys()]
    for b in sorted({b for b in blocks if re.fullmatch(r"conv\d_\d", b)}):
        _convert_conv(out, f"{b}.conv1", sd, f"{b}.conv1")
        _convert_bn(out, f"{b}.bn1", sd, f"{b}.bn1")
        _convert_conv(out, f"{b}.conv2", sd, f"{b}.conv2")
        _convert_bn(out, f"{b}.bn2", sd, f"{b}.bn2")
    for b in sorted({b for b in blocks if re.fullmatch(r"Up\d_\d", b)}):
        _convert_tconv(out, f"{b}.up", sd, f"{b}.up")
    for ca in ("ca", "ca1"):
        _convert_conv(out, f"{ca}.fc1", sd, f"{ca}.fc1")
        _convert_conv(out, f"{ca}.fc2", sd, f"{ca}.fc2")
    _convert_conv(out, "conv_final", sd, "conv_final")
    return _tensors(out)


# ---------------------------------------------------------------------------
# FloodViT (reference models/vision_transformer.py)
# ---------------------------------------------------------------------------

def _floodvit(out: dict, pre: str, sd) -> None:
    """The lucidrains-style ViT: to_patch_embedding.1 (LN), .2 (Linear), .3
    (LN); pos_embedding; cls_token; transformer.layers.{i}.0 = Attention
    (norm, to_qkv, to_out.0), .1 = FeedForward (net.0 LN, net.1 fc1, net.4
    fc2); transformer.norm; mlp_head where the file has one."""
    _convert_ln(out, f"{pre}patch_norm1", sd, "to_patch_embedding.1")
    _convert_dense(out, f"{pre}patch_proj", sd, "to_patch_embedding.2")
    _convert_ln(out, f"{pre}patch_norm2", sd, "to_patch_embedding.3")
    out[f"{pre}pos_embedding"] = sd["pos_embedding"]
    out[f"{pre}cls_token"] = sd["cls_token"]
    i = 0
    while f"transformer.layers.{i}.0.to_qkv.weight" in sd:
        t, m = f"transformer.layers.{i}", f"{pre}transformer"
        _convert_ln(out, f"{m}.attn_{i}.norm", sd, f"{t}.0.norm")
        _convert_dense(out, f"{m}.attn_{i}.to_qkv", sd, f"{t}.0.to_qkv")
        _convert_dense(out, f"{m}.attn_{i}.to_out", sd, f"{t}.0.to_out.0")
        _convert_ln(out, f"{m}.ff_{i}.norm", sd, f"{t}.1.net.0")
        _convert_dense(out, f"{m}.ff_{i}.fc1", sd, f"{t}.1.net.1")
        _convert_dense(out, f"{m}.ff_{i}.fc2", sd, f"{t}.1.net.4")
        i += 1
    _convert_ln(out, f"{pre}transformer.norm", sd, "transformer.norm")
    if "mlp_head.weight" in sd:
        _convert_dense(out, f"{pre}mlp_head", sd, "mlp_head")


def convert_floodvit(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    out: dict = {}
    _floodvit(out, "", sd)
    return _tensors(out)


def convert_finetune(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """FinetunerSegmentation (model_utilities.py:50-94): ``model.*`` is the
    FloodViT encoder, ``head.*`` one of two 1x1 convs (mlp), the 3-deconv
    Decoder, or one 1x1 conv (linear)."""
    out: dict = {}
    _floodvit(out, "encoder.", {k[len("model."):]: v for k, v in sd.items()
                                if k.startswith("model.")})
    if "head.0.weight" in sd:  # mlp: Conv1x1 -> ReLU -> Conv1x1
        _convert_conv(out, "head_fc1", sd, "head.0")
        _convert_conv(out, "head_fc2", sd, "head.2")
    elif "head.deconv1.weight" in sd:
        for d in ("deconv1", "deconv2", "deconv3"):
            _convert_tconv(out, f"head.{d}", sd, f"head.{d}")
    elif "head.weight" in sd:  # linear: one 1x1 conv
        _convert_conv(out, "head_fc", sd, "head")
    else:
        raise KeyError("unrecognized finetune head layout in state_dict")
    return _tensors(out)


# ---------------------------------------------------------------------------
# Siamese UNets (reference models/siam_diff.py, siam_conc.py)
# ---------------------------------------------------------------------------

_SIAM_ENC = [("c11", "11"), ("c12", "12"), ("c21", "21"), ("c22", "22"), ("c31", "31"),
             ("c32", "32"), ("c33", "33"), ("c41", "41"), ("c42", "42"), ("c43", "43")]
_SIAM_DEC = [("dec4_0", "43d"), ("dec4_1", "42d"), ("dec4_2", "41d"), ("dec3_0", "33d"),
             ("dec3_1", "32d"), ("dec3_2", "31d"), ("dec2_0", "22d"), ("dec2_1", "21d"),
             ("dec1_0", "12d")]


def convert_siam(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    out: dict = {}
    for ours, theirs in _SIAM_ENC:
        _convert_conv(out, f"encoder.{ours}.conv", sd, f"conv{theirs}")
        _convert_bn(out, f"encoder.{ours}.bn", sd, f"bn{theirs}")
    for i in (4, 3, 2, 1):
        _convert_tconv(out, f"upconv{i}", sd, f"upconv{i}")
    for ours, theirs in _SIAM_DEC:
        _convert_tconv(out, f"{ours}.conv", sd, f"conv{theirs}")
        _convert_bn(out, f"{ours}.bn", sd, f"bn{theirs}")
    _convert_tconv(out, "classifier", sd, "conv11d")
    return _tensors(out)


# ---------------------------------------------------------------------------
# ResNets: BiT-CD's trunk and the torchvision encoders (smp's imagenet
# encoders for the UNet, UNet++ and DeepLabV3+)
# ---------------------------------------------------------------------------

def _resnet(out: dict, pre: str, sd, key: str) -> None:
    """A torchvision ResNet under ``key`` (``""``, ``"resnet."``,
    ``"encoder."``) onto the port's ResNetEncoder under ``pre``: BasicBlock
    and Bottleneck, the downsample at ``ConvBNAct_{n_convs}``."""
    _convert_conv(out, f"{pre}stem.Conv_0", sd, f"{key}conv1")
    _convert_bn(out, f"{pre}stem.BatchNorm_0", sd, f"{key}bn1")
    for s in (1, 2, 3, 4):
        i = 0
        while f"{key}layer{s}.{i}.conv1.weight" in sd:
            t, m = f"{key}layer{s}.{i}", f"{pre}layer{s}_{i}"
            n_convs = 3 if f"{t}.conv3.weight" in sd else 2
            for ci in range(n_convs):
                _convert_conv(out, f"{m}.ConvBNAct_{ci}.Conv_0", sd, f"{t}.conv{ci + 1}")
                _convert_bn(out, f"{m}.ConvBNAct_{ci}.BatchNorm_0", sd, f"{t}.bn{ci + 1}")
            if f"{t}.downsample.0.weight" in sd:
                _convert_conv(out, f"{m}.ConvBNAct_{n_convs}.Conv_0", sd, f"{t}.downsample.0")
                _convert_bn(out, f"{m}.ConvBNAct_{n_convs}.BatchNorm_0", sd,
                            f"{t}.downsample.1")
            i += 1


def convert_torchvision_resnet(sd: Mapping[str, np.ndarray],
                               prefix: str = "") -> dict[str, torch.Tensor]:
    """torchvision resnet{18,34,50,101} -> the port's ResNetEncoder
    ``state_dict`` (names relative to the encoder); ``prefix`` strips a
    leading module path (``"resnet."``, ``"encoder."``)."""
    out: dict = {}
    _resnet(out, "", sd, prefix)
    return _tensors(out)


def graft_encoder(state: Mapping[str, torch.Tensor], encoder: Mapping[str, torch.Tensor],
                  encoder_name: str = "encoder") -> dict[str, torch.Tensor]:
    """``state`` (a model's ``state_dict``) with its ``encoder_name``
    subtrees replaced by ``encoder``'s (:func:`convert_torchvision_resnet`),
    each block whole. The stem (its conv, its BatchNorm's affine and its
    statistics) keeps ``state``'s where the two stem kernels' shapes differ:
    6 SAR channels against ImageNet's 3, as smp patches the first conv.
    The kernels are compared by name: an order of leaves once compared a
    BatchNorm bias with the kernel and skipped even a 3-channel stem."""
    pre = f"{encoder_name}."
    keep_stem = (tuple(state[f"{pre}stem.Conv_0.weight"].shape)
                 != tuple(encoder["stem.Conv_0.weight"].shape))
    out = dict(state)
    for block in sorted({k.split(".")[0] for k in encoder}):
        if block == "stem" and keep_stem:
            continue
        ours = {k for k in state if k.startswith(f"{pre}{block}.")}
        theirs = {f"{pre}{k}" for k in encoder if k.startswith(f"{block}.")}
        if ours != theirs:
            raise KeyError(f"the pretrained encoder's {block} does not match the model's: "
                           f"{sorted(ours ^ theirs)[:6]}")
        out.update({k: encoder[k[len(pre):]] for k in theirs})
    return out


def convert_bit_resnet(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """bit_cd.ResNet (net_G base_resnet18, the shipped config)."""
    out: dict = {}
    _bit_resnet(out, sd)
    return _tensors(out)


def _bit_resnet(out: dict, sd) -> None:
    _resnet(out, "backbone.resnet.", sd, "resnet.")
    _convert_conv(out, "backbone.conv_pred", sd, "conv_pred")
    _convert_conv(out, "classifier.ConvBNAct_0.Conv_0", sd, "classifier.0")
    _convert_bn(out, "classifier.ConvBNAct_0.BatchNorm_0", sd, "classifier.1")
    _convert_conv(out, "classifier.Conv_0", sd, "classifier.3")


def convert_bit_transformer(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """BASE_Transformer (bit_cd.py:802-934): the trunk, conv_pred and
    classifier as :func:`convert_bit_resnet`, the tokenizer, the token
    encoder (PreNorm Attention and FeedForward, net.0 / net.3) and the
    per-frame decoder (PreNorm2: query and memory share the norm)."""
    out: dict = {}
    _bit_resnet(out, sd)
    out["pos_embedding"] = sd["pos_embedding"]
    _convert_conv(out, "conv_a", sd, "conv_a")
    for part, projections in (("transformer", ("to_qkv",)),
                              ("transformer_decoder", ("to_q", "to_k", "to_v"))):
        i = 0
        while f"{part}.layers.{i}.0.fn.norm.weight" in sd:
            t = f"{part}.layers.{i}"
            _convert_ln(out, f"{part}.norm_attn_{i}", sd, f"{t}.0.fn.norm")
            for proj in projections:
                _convert_dense(out, f"{part}.attn_{i}.{proj}", sd, f"{t}.0.fn.fn.{proj}")
            _convert_dense(out, f"{part}.attn_{i}.to_out", sd, f"{t}.0.fn.fn.to_out.0")
            _convert_ln(out, f"{part}.norm_ff_{i}", sd, f"{t}.1.fn.norm")
            _convert_dense(out, f"{part}.ff_{i}.Dense_0", sd, f"{t}.1.fn.fn.net.0")
            _convert_dense(out, f"{part}.ff_{i}.Dense_1", sd, f"{t}.1.fn.fn.net.3")
            i += 1
    return _tensors(out)


# ---------------------------------------------------------------------------
# ConvLSTM (reference models/convlstm.py)
# ---------------------------------------------------------------------------

def convert_convlstm(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Cell convs are Sequential(conv, GroupNorm) -> {cell}.conv and
    {cell}.norm; the encoder's strided convs keep their names; only
    transconv_3d reaches the output (the reference's transconv_1d/2d are
    dead compute)."""
    out: dict = {}
    for enc in ("conv_1e", "conv_2e", "conv_3e"):
        _convert_conv(out, enc, sd, enc)
    for cell in ("clstm_1e", "clstm_2e", "clstm_3e", "clstm_1d", "clstm_2d", "clstm_3d"):
        _convert_conv(out, f"{cell}.conv", sd, f"{cell}.conv.0")
        _convert_gn(out, f"{cell}.norm", sd, f"{cell}.conv.1")
    _convert_tconv(out, "transconv_3d", sd, "transconv_3d")
    return _tensors(out)


# ---------------------------------------------------------------------------
# TransUNet-CD (reference models/transunet_cd.py)
# ---------------------------------------------------------------------------

def _convert_convbn_folded(out: dict, name: str, sd, conv_key: str, bn_key: str) -> None:
    """Conv(+bias) -> BN onto a bias-free ConvBNAct: BN(x + b) is BN'(x)
    with mean' = mean - b, exactly; one subtraction in the file's dtype, as
    numpy does it in the JAX package."""
    out[f"{name}.Conv_0.weight"] = sd[f"{conv_key}.weight"]
    mean = sd[f"{bn_key}.running_mean"]
    if f"{conv_key}.bias" in sd:
        mean = mean - sd[f"{conv_key}.bias"]
    out[f"{name}.BatchNorm_0.scale"] = sd[f"{bn_key}.weight"]
    out[f"{name}.BatchNorm_0.bias"] = sd[f"{bn_key}.bias"]
    out[f"{name}.BatchNorm_0.mean"] = mean
    out[f"{name}.BatchNorm_0.var"] = sd[f"{bn_key}.running_var"]


def _transunet_encoder(out: dict, sd, t: str) -> None:
    _convert_convbn_folded(out, f"{t}.conv1", sd, f"{t}.conv1", f"{t}.norm1")
    for k in (1, 2, 3):
        b = f"{t}.encoder{k}"
        _convert_convbn_folded(out, f"{b}.downsample", sd, f"{b}.downsample.0",
                               f"{b}.downsample.1")
        for ci in (1, 2, 3):
            _convert_convbn_folded(out, f"{b}.conv{ci}", sd, f"{b}.conv{ci}", f"{b}.norm{ci}")
    vt = f"{t}.vit"
    _convert_dense(out, f"{vt}.projection", sd, f"{vt}.projection")
    out[f"{vt}.embedding"] = sd[f"{vt}.embedding"]
    out[f"{vt}.cls_token"] = sd[f"{vt}.cls_token"]
    i = 0
    while f"{vt}.transformer.layer_blocks.{i}.layer_norm1.weight" in sd:
        tb, mb = f"{vt}.transformer.layer_blocks.{i}", f"{vt}.block_{i}"
        _convert_dense(out, f"{mb}.qkv", sd, f"{tb}.multi_head_attention.qkv_layer")
        _convert_dense(out, f"{mb}.out_attention", sd,
                       f"{tb}.multi_head_attention.out_attention")
        _convert_ln(out, f"{mb}.norm1", sd, f"{tb}.layer_norm1")
        _convert_ln(out, f"{mb}.norm2", sd, f"{tb}.layer_norm2")
        _convert_dense(out, f"{mb}.fc1", sd, f"{tb}.mlp.mlp_layers.0")
        _convert_dense(out, f"{mb}.fc2", sd, f"{tb}.mlp.mlp_layers.3")
        i += 1
    _convert_convbn_folded(out, f"{t}.conv2", sd, f"{t}.conv2", f"{t}.norm2")


def convert_transunet_cd(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    out: dict = {}
    for t in (("encoder",) if "encoder.conv1.weight" in sd else ("encoder1", "encoder2")):
        _transunet_encoder(out, sd, t)
    for k in (1, 2, 3, 4):
        d = f"decoder.decoder{k}"
        _convert_convbn_folded(out, f"decoder{k}.conv1", sd, f"{d}.layer.0", f"{d}.layer.1")
        _convert_convbn_folded(out, f"decoder{k}.conv2", sd, f"{d}.layer.3", f"{d}.layer.4")
    _convert_conv(out, "head", sd, "decoder.conv1")
    return _tensors(out)


# ---------------------------------------------------------------------------
# HFA-Net (reference models/hfanet.py)
# ---------------------------------------------------------------------------

def _convert_cbp(out: dict, name: str, sd, conv_key: str, bn_key: str, prelu_key: str) -> None:
    """ConvBNPReLU: conv(+bias) -> BN -> PReLU."""
    _convert_conv(out, f"{name}.Conv_0", sd, conv_key)
    _convert_bn(out, f"{name}.BatchNorm_0", sd, bn_key)
    out[f"{name}.PReLU_0.alpha"] = sd[f"{prelu_key}.weight"]


_HFA_SA = [("conv1_1", "bn1_1", "ReLU1_1"), ("conv1_2", "bn1_2", "ReLU1_2"),
           ("conv2_1", "bn2_1", "ReLU2_1"), ("conv2_2", "bn2_2", "ReLU2_2"),
           ("conv_b_1", "bn_b_1", "ReLU_b_1"), ("conv_b_2", "bn_b_2", "ReLU_b_2"),
           ("conv3_1", "bn3_1", "ReLU3_1"), ("conv3_2", "bn3_2", "ReLU3_2"),
           ("conv4_1", "bn4_1", "ReLU4_1"), ("conv4_2", "bn4_2", "ReLU4_2"),
           ("conv5_1", "bn5_1", "ReLU5_1")]


def _convert_hfab(out: dict, name: str, sd, t: str) -> None:
    """HFAB: the SpatialAttentionStage (a mini-UNet to a sigmoid mask,
    ConvBNPReLU_0..10 in order) and the channel branch HF."""
    sa, ts = f"{name}.sa", f"{t}.SA"
    for n, (ck, bk, pk) in enumerate(_HFA_SA):
        _convert_cbp(out, f"{sa}.ConvBNPReLU_{n}", sd, f"{ts}.{ck}", f"{ts}.{bk}", f"{ts}.{pk}")
    _convert_tconv(out, f"{sa}.TorchConvTranspose_0", sd, f"{ts}.convtrans_1")
    _convert_tconv(out, f"{sa}.TorchConvTranspose_1", sd, f"{ts}.convtrans_2")
    _convert_conv(out, f"{sa}.Conv_0", sd, f"{ts}.conv5_2")
    _convert_bn(out, f"{sa}.BatchNorm_0", sd, f"{ts}.bn5_2")
    hf = f"{t}.HF"
    _convert_dense(out, f"{name}.hf.fc1", sd, f"{hf}.FC_1")
    out[f"{name}.hf.PReLU_0.alpha"] = sd[f"{hf}.ReLU.weight"]
    _convert_dense(out, f"{name}.hf.fc2", sd, f"{hf}.FC_2")
    _convert_conv(out, f"{name}.hf.fusion", sd, f"{hf}.Channelfusion")


def convert_hfanet(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    out: dict = {}
    _convert_conv(out, "encoder.pre_treat", sd, "encoder._pre_treat_2")
    # _layer_i = Sequential(HFAB, Conv, BN, PReLU, HFAB, Conv, BN, PReLU)
    for i in range(1, 6):
        t, m = f"encoder._layer_{i}", f"encoder.layer_{i}"
        _convert_hfab(out, f"{m}.hfab1", sd, f"{t}.0")
        _convert_cbp(out, f"{m}.conv1", sd, f"{t}.1", f"{t}.2", f"{t}.3")
        _convert_hfab(out, f"{m}.hfab2", sd, f"{t}.4")
        _convert_cbp(out, f"{m}.conv2", sd, f"{t}.5", f"{t}.6", f"{t}.7")
    for i in range(1, 5):
        _convert_conv(out, f"skip_fusion_{i}", sd, f"skip_connection_feature_fusion_{i}")
    _convert_conv(out, "bottom_fusion", sd, "bottom_feature_fusion")
    # _up_sample_i = Sequential(conv1x1, Upsample); _up_layer_i =
    # Sequential(Conv, BN, PReLU, HFAB, Conv, BN, PReLU, HFAB)
    for i in range(1, 5):
        m, tl = f"up_{i}", f"decoder._up_layer_{i}"
        _convert_conv(out, f"{m}.reduce", sd, f"decoder._up_sample_{i}.0")
        _convert_cbp(out, f"{m}.conv1", sd, f"{tl}.0", f"{tl}.1", f"{tl}.2")
        _convert_hfab(out, f"{m}.hfab1", sd, f"{tl}.3")
        _convert_cbp(out, f"{m}.conv2", sd, f"{tl}.4", f"{tl}.5", f"{tl}.6")
        _convert_hfab(out, f"{m}.hfab2", sd, f"{tl}.7")
    # Sequential(Conv, BN, PReLU, Conv, BN, PReLU, Conv1x1)
    t = "decoder._out_layer"
    _convert_cbp(out, "out1", sd, f"{t}.0", f"{t}.1", f"{t}.2")
    _convert_cbp(out, "out2", sd, f"{t}.3", f"{t}.4", f"{t}.5")
    _convert_conv(out, "head", sd, f"{t}.6")
    return _tensors(out)


# ---------------------------------------------------------------------------
# ChangeFormerV6 (reference models/changeformer.py)
# ---------------------------------------------------------------------------

def convert_changeformer(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    out: dict = {}
    for s in range(1, 5):
        pe = f"Tenc_x2.patch_embed{s}"
        _convert_conv(out, f"{pe}.proj", sd, f"{pe}.proj")
        _convert_ln(out, f"{pe}.norm", sd, f"{pe}.norm")
        i = 0
        while f"Tenc_x2.block{s}.{i}.norm1.weight" in sd:
            tb, mb = f"Tenc_x2.block{s}.{i}", f"Tenc_x2.block{s}_{i}"
            _convert_ln(out, f"{mb}.norm1", sd, f"{tb}.norm1")
            _convert_dense(out, f"{mb}.attn.q", sd, f"{tb}.attn.q")
            _convert_dense(out, f"{mb}.attn.kv", sd, f"{tb}.attn.kv")
            if f"{tb}.attn.sr.weight" in sd:
                _convert_conv(out, f"{mb}.attn.sr", sd, f"{tb}.attn.sr")
                _convert_ln(out, f"{mb}.attn.norm", sd, f"{tb}.attn.norm")
            _convert_dense(out, f"{mb}.attn.proj", sd, f"{tb}.attn.proj")
            _convert_ln(out, f"{mb}.norm2", sd, f"{tb}.norm2")
            _convert_dense(out, f"{mb}.mlp.fc1", sd, f"{tb}.mlp.fc1")
            _convert_conv(out, f"{mb}.mlp.dwconv", sd, f"{tb}.mlp.dwconv.dwconv")
            _convert_dense(out, f"{mb}.mlp.fc2", sd, f"{tb}.mlp.fc2")
            i += 1
        _convert_ln(out, f"Tenc_x2.norm{s}", sd, f"Tenc_x2.norm{s}")
    dec = "TDec_x2"
    for s in range(1, 5):
        _convert_dense(out, f"{dec}.linear_c{s}", sd, f"{dec}.linear_c{s}.proj")
        # Sequential(conv, relu, bn, conv, relu): indices 0, 2, 3
        for part in (f"diff_c{s}", f"make_pred_c{s}"):
            _convert_conv(out, f"{dec}.{part}.Conv_0", sd, f"{dec}.{part}.0")
            _convert_bn(out, f"{dec}.{part}.BatchNorm_0", sd, f"{dec}.{part}.2")
            _convert_conv(out, f"{dec}.{part}.Conv_1", sd, f"{dec}.{part}.3")
    _convert_conv(out, f"{dec}.linear_fuse", sd, f"{dec}.linear_fuse.0")
    _convert_bn(out, f"{dec}.fuse_bn", sd, f"{dec}.linear_fuse.1")
    _convert_tconv(out, f"{dec}.convd2x", sd, f"{dec}.convd2x.conv2d")
    _convert_tconv(out, f"{dec}.convd1x", sd, f"{dec}.convd1x.conv2d")
    for name in ("dense_2x", "dense_1x"):
        _convert_conv(out, f"{dec}.{name}.conv1", sd, f"{dec}.{name}.0.conv1.conv2d")
        _convert_conv(out, f"{dec}.{name}.conv2", sd, f"{dec}.{name}.0.conv2.conv2d")
    _convert_conv(out, f"{dec}.change_probability", sd, f"{dec}.change_probability.conv2d")
    return _tensors(out)


# ---------------------------------------------------------------------------
# ADHR-CDNet (reference models/adhr_cdnet.py:111-576)
# ---------------------------------------------------------------------------

def _convert_convbn_pair(out: dict, name: str, sd, conv_key: str, bn_key: str) -> None:
    """A (convX, bnX) pair -> the model's _ConvBN (Conv_0 + BatchNorm_0)."""
    _convert_conv(out, f"{name}.Conv_0", sd, conv_key)
    _convert_bn(out, f"{name}.BatchNorm_0", sd, bn_key)


_ADHR_DOWN = {"t2_1to2": ["conv2_1to2"], "t2_1to3": ["conv2_1to3_1", "conv2_1to3_2"],
              "t2_2to3": ["conv2_2to3"], "t3_1to2": ["conv3_1to2"],
              "t3_1to3": ["conv3_1to3_1", "conv3_1to3_2"], "t3_2to3": ["conv3_2to3"],
              "t3_1to4": ["conv3_1to4_1", "conv3_1to4_2", "conv3_1to4_3"],
              "t3_2to4": ["conv3_2to4_1", "conv3_2to4_2"], "t3_3to4": ["conv3_3to4"]}


def convert_adhr(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Skips the reference's dead parameters (convf2/bnf2..., conv4_*to*,
    the shadowed 128->1 ``final`` at adhr_cdnet.py:285): constructed,
    never used in its forward."""
    out: dict = {}
    _convert_conv(out, "conv0_0", sd, "conv0_0")
    _convert_conv(out, "conv0", sd, "conv0")
    _convert_bn(out, "bn0", sd, "bn0")
    # part one: BottleneckN (bn3 shared with the shortcut) + 3 Bottlenecks
    t = "conv1_1_1"
    _convert_convbn_pair(out, f"{t}._ConvBN_0", sd, f"{t}.conv1", f"{t}.bn1")
    _convert_convbn_pair(out, f"{t}._ConvBN_1", sd, f"{t}.conv2", f"{t}.bn2")
    _convert_conv(out, f"{t}.conv3", sd, f"{t}.conv3")
    _convert_conv(out, f"{t}.conv1_1", sd, f"{t}.conv1_1")
    _convert_bn(out, f"{t}.bn3", sd, f"{t}.bn3")
    for i in (2, 3, 4):
        t = f"conv1_1_{i}"
        for c in (1, 2, 3):
            _convert_convbn_pair(out, f"{t}._ConvBN_{c - 1}", sd, f"{t}.conv{c}", f"{t}.bn{c}")
    _convert_convbn_pair(out, "trans1_1", sd, "conv1_1", "bn1_1")
    _convert_convbn_pair(out, "trans1_2", sd, "conv1_2", "bn1_2")
    # branch stages: stage{s}_b{j} <- conv{s}_{j}_{1..4}, BasicBlocks
    for s, branches in ((2, 2), (3, 3), (4, 4)):
        for j in range(1, branches + 1):
            for i in range(1, 5):
                m, t = f"stage{s}_b{j}.b{i}", f"conv{s}_{j}_{i}"
                _convert_convbn_pair(out, f"{m}._ConvBN_0", sd, f"{t}.conv1", f"{t}.bn1")
                _convert_convbn_pair(out, f"{m}._ConvBN_1", sd, f"{t}.conv2", f"{t}.bn2")
    # the differential VGG streams and their 1x1 fusers
    for s in (2, 3, 4):
        _convert_convbn_pair(out, f"conv{s}._ConvBN_0", sd, f"conv{s}.conv1", f"conv{s}.bn1")
        _convert_convbn_pair(out, f"conv{s}._ConvBN_1", sd, f"conv{s}.conv2", f"conv{s}.bn2")
        _convert_conv(out, f"c{s}", sd, f"c{s}")
    # exchange units (stages 2 and 3; stage 4 has none in the forward)
    for ours in ("t2_2to1", "t3_2to1", "t3_3to1", "t3_3to2"):
        ref = "conv" + ours[1:]
        _convert_convbn_pair(out, f"{ours}._ConvBN_0", sd, ref, ref.replace("conv", "bn", 1))
    for ours, refs in _ADHR_DOWN.items():
        for i, ref in enumerate(refs):
            _convert_convbn_pair(out, f"{ours}.d{i}", sd, ref, ref.replace("conv", "bn", 1))
    # the final fusion f{2,3,4} <- conv{2,3,4}f / bn{2,3,4}f (not the dead convf*)
    for s in (2, 3, 4):
        _convert_convbn_pair(out, f"f{s}._ConvBN_0", sd, f"conv{s}f", f"bn{s}f")
    for name in ("attention1", "attention2", "final"):
        _convert_conv(out, name, sd, name)
    return _tensors(out)


# ---------------------------------------------------------------------------
# UperNet (HF openmmlab/upernet-{convnext,swin}-* checkpoints, which the
# reference loads with from_pretrained, models/upernet.py:28-77)
# ---------------------------------------------------------------------------

def _convert_upernet_convbn(out: dict, name: str, sd, key: str) -> None:
    """HF UperNetConvModule: {key}.conv (no bias) + {key}.batch_norm."""
    _convert_conv(out, f"{name}.Conv_0", sd, f"{key}.conv")
    _convert_bn(out, f"{name}.BatchNorm_0", sd, f"{key}.batch_norm")


def _upernet_head(out: dict, sd) -> None:
    h = "decode_head"
    for i in range(3):
        _convert_upernet_convbn(out, f"{h}.lateral{i}", sd, f"{h}.lateral_convs.{i}")
        _convert_upernet_convbn(out, f"{h}.fpn_conv{i}", sd, f"{h}.fpn_convs.{i}")
    for i in range(4):
        _convert_upernet_convbn(out, f"{h}.psp.branch{i}", sd, f"{h}.psp_modules.{i}.1")
    _convert_upernet_convbn(out, f"{h}.psp.bottleneck", sd, f"{h}.bottleneck")
    _convert_upernet_convbn(out, f"{h}.fpn_bottleneck", sd, f"{h}.fpn_bottleneck")
    _convert_conv(out, f"{h}.classifier", sd, f"{h}.classifier")


def convert_upernet_convnext(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    out: dict = {}
    _convert_conv(out, "backbone.stem", sd, "backbone.embeddings.patch_embeddings")
    _convert_ln(out, "backbone.stem_norm", sd, "backbone.embeddings.layernorm")
    s = 0
    while f"backbone.encoder.stages.{s}.layers.0.dwconv.weight" in sd:
        st = f"backbone.encoder.stages.{s}"
        if s > 0:
            _convert_ln(out, f"backbone.down_norm{s}", sd, f"{st}.downsampling_layer.0")
            _convert_conv(out, f"backbone.down{s}", sd, f"{st}.downsampling_layer.1")
        b = 0
        while f"{st}.layers.{b}.dwconv.weight" in sd:
            t, p = f"{st}.layers.{b}", f"backbone.stage{s}_block{b}"
            _convert_conv(out, f"{p}.dwconv", sd, f"{t}.dwconv")
            _convert_ln(out, f"{p}.norm", sd, f"{t}.layernorm")
            _convert_dense(out, f"{p}.pwconv1", sd, f"{t}.pwconv1")
            _convert_dense(out, f"{p}.pwconv2", sd, f"{t}.pwconv2")
            out[f"{p}.gamma"] = sd[f"{t}.layer_scale_parameter"]
            b += 1
        _convert_ln(out, f"backbone.out_norm{s}", sd, f"backbone.hidden_states_norms.stage{s + 1}")
        s += 1
    _upernet_head(out, sd)
    return _tensors(out)


# HF's patch merging concatenates the 2x2 neighbours as (00, 10, 01, 11),
# the model row-major (00, 01, 10, 11)
_MERGE_ORDER = [0, 2, 1, 3]


def convert_upernet_swin(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    out: dict = {}
    _convert_conv(out, "backbone.patch_embed", sd, "backbone.embeddings.patch_embeddings.projection")
    _convert_ln(out, "backbone.patch_norm", sd, "backbone.embeddings.norm")
    s = 0
    while f"backbone.encoder.layers.{s}.blocks.0.layernorm_before.weight" in sd:
        if s > 0:
            # HF's downsample ends stage s-1; the model's merge{s} is the same
            # step in the chain. The reduction (2C, 4C) permutes its input
            # groups on dim 1; the norm over the concatenation, identically.
            ds = f"backbone.encoder.layers.{s - 1}.downsample"
            w = sd[f"{ds}.reduction.weight"]
            c = w.shape[1] // 4
            out[f"backbone.merge{s}.weight"] = (
                w.reshape(w.shape[0], 4, c)[:, _MERGE_ORDER].reshape(w.shape[0], 4 * c))
            perm = np.arange(4 * c).reshape(4, c)[_MERGE_ORDER].reshape(-1)
            out[f"backbone.merge_norm{s}.scale"] = sd[f"{ds}.norm.weight"][perm]
            out[f"backbone.merge_norm{s}.bias"] = sd[f"{ds}.norm.bias"][perm]
        b = 0
        while f"backbone.encoder.layers.{s}.blocks.{b}.layernorm_before.weight" in sd:
            t, p = f"backbone.encoder.layers.{s}.blocks.{b}", f"backbone.stage{s}_block{b}"
            att = f"{t}.attention"
            _convert_ln(out, f"{p}.norm1", sd, f"{t}.layernorm_before")
            for part in ("weight", "bias"):
                out[f"{p}.attn.qkv.{part}"] = np.concatenate(
                    [sd[f"{att}.self.{x}.{part}"] for x in ("query", "key", "value")], 0)
            out[f"{p}.attn.relative_position_bias"] = sd[
                f"{att}.self.relative_position_bias_table"]
            _convert_dense(out, f"{p}.attn.proj", sd, f"{att}.output.dense")
            _convert_ln(out, f"{p}.norm2", sd, f"{t}.layernorm_after")
            _convert_dense(out, f"{p}.fc1", sd, f"{t}.intermediate.dense")
            _convert_dense(out, f"{p}.fc2", sd, f"{t}.output.dense")
            b += 1
        _convert_ln(out, f"backbone.out_norm{s}", sd, f"backbone.hidden_states_norms.stage{s + 1}")
        s += 1
    _upernet_head(out, sd)
    return _tensors(out)


def convert_upernet(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Dispatch on the backbone family the HF state_dict holds."""
    if any("dwconv" in k for k in sd):
        return convert_upernet_convnext(sd)
    return convert_upernet_swin(sd)


def load_pretrained_upernet(model_dir: str | Path, num_channels: int,
                            num_classes: int) -> dict[str, torch.Tensor]:
    """``UperNetForSemanticSegmentation.from_pretrained`` of a LOCAL
    directory (``save_pretrained``'s; the port fetches nothing), as the
    reference loads openmmlab/upernet-* (upernet.py:28-77): the first conv
    replaced by a fresh one for ``num_channels``, the classifier by one for
    ``num_classes`` (both drawn from torch's global RNG, as there), then
    converted. Needs the ``transformers`` package."""
    if not Path(model_dir).is_dir():
        raise FileNotFoundError(
            f"pretrained_upernet {str(model_dir)!r} is not a local directory: the port loads "
            "UperNet weights from a save_pretrained directory only, and fetches nothing")
    from transformers import UperNetForSemanticSegmentation

    m = UperNetForSemanticSegmentation.from_pretrained(str(model_dir), local_files_only=True)
    emb = m.backbone.embeddings.patch_embeddings
    proj = getattr(emb, "projection", emb)  # Swin nests a .projection conv
    fresh = torch.nn.Conv2d(num_channels, proj.out_channels, kernel_size=proj.kernel_size,
                            stride=proj.stride, padding=proj.padding)
    if hasattr(emb, "projection"):
        emb.projection = fresh
        emb.num_channels = num_channels
    else:
        m.backbone.embeddings.patch_embeddings = fresh
    head = m.decode_head.classifier
    m.decode_head.classifier = torch.nn.Conv2d(head.in_channels, num_classes, kernel_size=1)
    return convert_upernet({k: v.detach().cpu().numpy() for k, v in m.state_dict().items()})


# ---------------------------------------------------------------------------
# smp.Unet (the reference's --method=unet checkpoint)
# ---------------------------------------------------------------------------

def convert_smp_unet(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """smp.Unet with a ResNet encoder (model_utilities.py:174-177; smp
    0.3.x's keys): ``encoder.*`` a torchvision ResNet, each decoder block
    two Conv2dReLU stages (``decoder.blocks.{i}.conv{1,2}.0`` conv, ``.1``
    BatchNorm) whose conv1 takes cat(upsampled, skip), as the port's
    DecoderBlock, and ``segmentation_head.0`` the 3x3 classifier."""
    out: dict = {}
    _resnet(out, "encoder.", sd, "encoder.")
    i = 0
    while f"decoder.blocks.{i}.conv1.0.weight" in sd:
        for ci in (1, 2):
            blk, t = f"DecoderBlock_{i}.ConvBNAct_{ci - 1}", f"decoder.blocks.{i}.conv{ci}"
            _convert_conv(out, f"{blk}.Conv_0", sd, f"{t}.0")
            _convert_bn(out, f"{blk}.BatchNorm_0", sd, f"{t}.1")
        i += 1
    _convert_conv(out, "head", sd, "segmentation_head.0")
    return _tensors(out)


CONVERTERS: dict[str, Callable[[Mapping[str, np.ndarray]], dict[str, torch.Tensor]]] = {
    "finetune": convert_finetune,
    "snunet": convert_snunet,
    "floodvit": convert_floodvit,
    "vit": convert_floodvit,
    "siam-diff": convert_siam,
    "siam-conc": convert_siam,
    "bit-cd": convert_bit_resnet,
    "bit-cd-transformer": convert_bit_transformer,
    "convlstm": convert_convlstm,
    "changeformer": convert_changeformer,
    "transunet-cd": convert_transunet_cd,
    "hfa-net": convert_hfanet,
    "adhr-cdnet": convert_adhr,
    "upernet": convert_upernet,
    "unet": convert_smp_unet,
}


def convert(path: str | Path, method: str) -> dict[str, torch.Tensor]:
    """A reference torch checkpoint file -> the port's ``state_dict`` for
    ``method``. A method with no converter raises before the file is
    unpickled."""
    if method not in CONVERTERS:
        raise KeyError(f"no converter for {method!r}; have {sorted(CONVERTERS)}")
    return CONVERTERS[method](load_torch_state_dict(path))
