"""Layered configuration; counterpart of ``kurosiwo_tpu/config.py``.

The same merge as the JAX package (and the reference's ``main.py:48-76``)::

    configs/config.json
      -> configs/method/<method>/<method>.json   (CLI --method/--backbone)
      -> configs/train/data_config.json          (CLI --inputs/--dem/--slope)
      -> configs/train/train_config.json
      -> configs/augmentations/augmentation.json (only with data_augmentations
                                                  or task self-supervised)

later files win by ``dict.update``; then the derived keys: ``num_channels``,
``class_weights`` and the empty activation lists. The JAX package's
``device`` key is not set: the port's placement is each entry point's
``device`` argument.

The files are JSON with ``//`` and ``/* */`` comments and trailing commas.
:func:`loads` reads them with the standard library: comments outside strings
go, a comma before ``}`` or ``]`` goes, and ``json.loads`` does the rest.
There is no ``json5`` on the card's machine, and this is the one reader.

The change-detection checkpoint directory is stamped with this process's
clock; the JAX package broadcasts process 0's stamp across processes, which
waits for the port's multi-process runtime (ROADMAP.md, A12).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

# Class weights for the RandomEvents track when `weighted` is enabled
# (reference: utilities/utilities.py:392-397).
RANDOM_EVENTS_CLASS_WEIGHTS = [0.3715753140309927, 14.009780283125977, 8.20405370357821]

#: label semantics (reference: training/segmentation_trainer.py:13)
CLASS_NO_WATER, CLASS_PERMANENT_WATER, CLASS_FLOOD, CLASS_INVALID = 0, 1, 2, 3
IGNORE_INDEX = 3


def strip_json_comments(text: str) -> str:
    """``text`` without its comments and trailing commas: what remains is
    plain JSON. Strings (with their escapes) are copied as they are."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        elif text.startswith("//", i):
            end = text.find("\n", i)
            i = n if end < 0 else end
        elif text.startswith("/*", i):
            end = text.find("*/", i + 2)
            if end < 0:
                raise ValueError("unterminated /* comment")
            i = end + 2
        else:
            if c in "}]":
                k = len(out) - 1
                while k >= 0 and out[k].isspace():
                    k -= 1
                if k >= 0 and out[k] == ",":
                    del out[k]
            out.append(c)
            i += 1
    return "".join(out)


def loads(text: str) -> Any:
    return json.loads(strip_json_comments(text))


def load_json5(path: str | os.PathLike) -> dict:
    with open(path) as f:
        return loads(f.read())


def _find_method_config(config_root: Path, method: str) -> Path:
    """Locate configs/method/<m>/<m>.json, tolerating the -/_ spelling split
    and the reference's temporal/ directory convention for convlstm/vivit."""
    m = method.lower()
    fname = m.replace("-", "_") + ".json"
    candidates = [
        config_root / "method" / m / fname,
        config_root / "method" / "temporal" / fname,
    ]
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"no method config for {method!r}; looked at {[str(c) for c in candidates]}")


def derive_num_channels(config: dict) -> int:
    """Channel math (reference: utilities/utilities.py:376-390).

    cd / convlstm feed each acquisition separately -> channels per frame;
    otherwise frames are channel-concatenated -> channels x inputs. DEM adds 1.
    SLC rasters carry double channels (4 vs 2).
    """
    if config.get("task") == "cd" or config.get("method") == "convlstm":
        n = len(config["channels"])
    else:
        n = len(config["channels"]) * len(config["inputs"])
    if config.get("dem"):
        n += 1
    if config.get("slc"):
        n = (n - 1) * 2 + 1 if config.get("dem") else n * 2
    return n


def update_config(config: dict, args=None, config_root: str | os.PathLike = "configs",
                  overrides: dict | None = None) -> dict:
    """Merge data/train/augmentation configs and compute derived keys.

    ``args`` may be an argparse.Namespace (or any object) with optional
    attributes inputs/dem/slope, mirroring utilities/utilities.py:350-374.
    ``overrides`` win over every merged file and are applied before the
    augmentation-file check so keys like data_augmentations take effect.
    """
    config_root = Path(config_root)
    config = dict(config)
    config.update(load_json5(config_root / "train" / "data_config.json"))
    if args is not None:
        if getattr(args, "inputs", None) is not None:
            config["inputs"] = args.inputs
        if getattr(args, "dem", False):
            config["dem"] = True
            if getattr(args, "slope", False):
                config["slope"] = True
    config.update(load_json5(config_root / "train" / "train_config.json"))
    if overrides:
        config.update(overrides)
    if config.get("task") == "self-supervised" or config.get("data_augmentations"):
        config.update(load_json5(config_root / "augmentations" / "augmentation.json"))

    config["num_channels"] = derive_num_channels(config)
    if config.get("weighted") and config.get("track") == "RandomEvents":
        config["class_weights"] = list(RANDOM_EVENTS_CLASS_WEIGHTS)
    else:
        config["class_weights"] = [1.0, 1.0, 1.0]
    for k in ("train_acts", "val_acts", "test_acts"):
        config.setdefault(k, [])
    return config


def load_config(method: str | None = None, backbone: str | None = None,
                config_root: str | os.PathLike = "configs", args=None,
                overrides: dict | None = None) -> dict:
    """Full config assembly as done by the reference main.py __main__ block."""
    config_root = Path(config_root)
    config = load_json5(config_root / "config.json")
    if method is not None:
        config["method"] = method
    model_config = load_json5(_find_method_config(config_root, config["method"]))
    if backbone is not None and config["method"] not in ("convlstm", "vivit"):
        model_config["backbone"] = backbone
    config.update(model_config)
    config = update_config(config, args=args, config_root=config_root, overrides=overrides)
    if overrides:
        # overrides also win over the augmentation-file merge, with the
        # channel math recomputed from the final values, and reach the keys
        # the factories read from model_config
        config.update(overrides)
        config["num_channels"] = derive_num_channels(config)
        model_config.update(overrides)
    config["model_config"] = model_config
    return config


def create_checkpoint_directory(config: dict, model_config: dict, root: str = "checkpoints") -> str:
    """Checkpoint directory naming parity (utilities/utilities.py:15-70),
    created under the working directory."""
    method = config["method"]
    if "vit" in method.lower():
        path = (
            f"{root}/{method}_patch{model_config['patch_size']}"
            f"_depth{model_config['depth']}_num_heads{model_config['num_heads']}"
            f"/input_patches_{len(config['inputs'])}/{config['track']}"
        )
    elif config.get("task") == "diffusion-unsup":
        path = f"{root}/diffusion-unsup/"
    elif config.get("task") == "segmentation":
        if model_config.get("backbone"):
            path = (
                f"{root}/{model_config['architecture']}/{model_config['backbone']}/"
                + "-".join(config["channels"])
                + f"_patches_{len(config['inputs'])}/{config['track']}"
            )
        else:
            path = f"{root}/{model_config.get('architecture', method)}"
    elif config.get("task") == "mae":
        bb = model_config.get("backbone", "vit").lower()
        path = f"{root}/{method.lower()}/{bb}/{bb}_{config['num_channels']}/{config['track']}"
    elif config.get("task") == "cd":
        from datetime import datetime

        path = f"{root}/{method.lower()}/{config['track']}_{datetime.now():%Y%m%d%H%M%S}"
    elif config.get("task") == "finetune":
        path = f"{root}/finetuning"
    else:
        path = f"{root}/{method.lower()}"
    Path(path).mkdir(parents=True, exist_ok=True)
    return path
