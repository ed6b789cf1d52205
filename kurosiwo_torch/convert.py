"""Parameter bridge between a flax model's variables and the port's
``state_dict`` (the UNet and the MAE/ViT trees).

The port names its submodules after the flax paths (``encoder.stem.Conv_0``,
``encoder.layer1_0.ConvBNAct_0.BatchNorm_0``, ``DecoderBlock_4.ConvBNAct_1``,
``head``; ``encoder.transformer.attn_3.to_qkv``, ``decoder.ff_0.fc1``,
``enc_to_dec``, ``decoder_pos_emb``, ``to_pixels``), so the map is a path
join plus layout transposes:

  params/.../kernel (HWIO, conv)  <-> ....weight (OIHW)
  params/.../kernel (in, out)     <-> ....weight (out, in)   (Dense)
  params/.../{bias, scale, embedding, pos_embedding, cls_token, mask_token}
                                  <-> the same name, as it is
  batch_stats/.../{mean, var}     <-> ....{mean, var}   (buffers)

Inputs and outputs are numpy arrays (or anything ``np.asarray`` takes);
the transposes are exact, so a round trip is bit-exact.
"""

from __future__ import annotations

from typing import Any, Mapping

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
