"""The port's config layer (kurosiwo_torch.config) against the JAX package's
(kurosiwo_tpu.config) on the repository's configs/.

Exactness class (ROADMAP C5): bit-exact. The reader is held to json5 on
every shipped file, and the merged configs, channel counts and checkpoint
paths are equal to the JAX package's.
"""

import argparse
import os
import pathlib

import json5
import pytest

from kurosiwo_torch import config as tcfg
from kurosiwo_tpu import config as jcfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs"
JSON_FILES = sorted(CONFIGS.rglob("*.json"))


def test_every_shipped_config_file_is_found():
    assert len(JSON_FILES) == 22


@pytest.mark.parametrize("path", JSON_FILES, ids=lambda p: str(p.relative_to(CONFIGS)))
def test_reader_matches_json5(path):
    text = path.read_text()
    assert tcfg.loads(text) == json5.loads(text)


def test_reader_keeps_strings_and_drops_comments_and_trailing_commas():
    text = """{
      // a line comment with "quotes" and a trailing comma,
      "url": "http://host/a//b", /* a block
      comment */ "star": "/* not a comment */",
      "esc": "a \\" // still in the string",
      "list": [1, 2, /* three */ 3,  ],
      "nested": {"k": [ ], "j": {}, },
    }"""
    assert tcfg.loads(text) == json5.loads(text) == {
        "url": "http://host/a//b", "star": "/* not a comment */",
        "esc": 'a " // still in the string', "list": [1, 2, 3],
        "nested": {"k": [], "j": {}},
    }


def _args(**kw):
    return argparse.Namespace(**{"inputs": None, "dem": False, "slope": False, **kw})


CASES = {
    "unet-resnet18": dict(method="unet", backbone="resnet18"),
    "unet-resnet34-dem": dict(method="unet", backbone="resnet34", args=_args(dem=True)),
    "unet-dem-slope": dict(method="unet", args=_args(dem=True, slope=True)),
    "post-only": dict(method="unet", args=_args(inputs=["post_event"])),
    "pre1-post": dict(method="unet", args=_args(inputs=["pre_event_1", "post_event"])),
    "pre2-post-dem": dict(method="unet", args=_args(inputs=["pre_event_2", "post_event"],
                                                    dem=True)),
    "overrides": dict(method="unet", overrides={"batch_size": 4, "weighted": True,
                                                "data_augmentations": True, "dem": True}),
    "mae": dict(method="mae", overrides={"task": "mae"}),
    "convlstm": dict(method="convlstm", backbone="resnet18"),
}


def _without_device(config):
    # the JAX package's placement key ("tpu"); the port places by each entry
    # point's device argument and sets no such key
    assert config.pop("device") == "tpu"
    return config


@pytest.mark.parametrize("kw", CASES.values(), ids=CASES.keys())
def test_load_config_matches_jax(kw):
    got = tcfg.load_config(config_root=CONFIGS, **kw)
    want = _without_device(jcfg.load_config(config_root=CONFIGS, **kw))
    assert got == want


@pytest.mark.parametrize("overrides", [None, {"task": "cd", "dem": True}, {"slc": True}],
                         ids=["none", "cd-dem", "slc"])
def test_update_config_matches_jax(overrides):
    base = tcfg.load_json5(CONFIGS / "config.json")
    args = _args(inputs=["pre_event_1", "post_event"], dem=True)
    assert (tcfg.update_config(base, args, CONFIGS, overrides)
            == _without_device(jcfg.update_config(base, args, CONFIGS, overrides)))


@pytest.mark.parametrize("cfg", [
    {"channels": ["vv", "vh"], "inputs": ["post_event"]},
    {"channels": ["vv", "vh"], "inputs": ["pre_event_1", "pre_event_2", "post_event"], "dem": True},
    {"channels": ["vv", "vh", "vh/vv"], "inputs": ["pre_event_1", "post_event"]},
    {"channels": ["vv", "vh"], "inputs": ["pre_event_1", "post_event"], "task": "cd", "dem": True},
    {"channels": ["vh"], "inputs": ["post_event"], "method": "convlstm"},
    {"channels": ["vv", "vh"], "inputs": ["post_event"], "slc": True},
    {"channels": ["vv", "vh"], "inputs": ["post_event"], "slc": True, "dem": True},
], ids=["post", "all-dem", "ratio", "cd-dem", "convlstm", "slc", "slc-dem"])
def test_derive_num_channels_matches_jax(cfg):
    assert tcfg.derive_num_channels(cfg) == jcfg.derive_num_channels(cfg)


def test_class_weights_are_the_random_events_weights():
    assert tcfg.RANDOM_EVENTS_CLASS_WEIGHTS == jcfg.RANDOM_EVENTS_CLASS_WEIGHTS
    cfg = tcfg.load_config(config_root=CONFIGS, overrides={"weighted": True})
    assert cfg["class_weights"] == jcfg.RANDOM_EVENTS_CLASS_WEIGHTS


@pytest.mark.parametrize("method,overrides", [("unet", None), ("mae", {"task": "mae"})],
                         ids=["segmentation", "mae"])
def test_create_checkpoint_directory_matches_jax(tmp_path, monkeypatch, method, overrides):
    monkeypatch.chdir(tmp_path)
    cfg = tcfg.load_config(method=method, config_root=CONFIGS, overrides=overrides)
    got = tcfg.create_checkpoint_directory(cfg, cfg["model_config"])
    want = jcfg.create_checkpoint_directory(cfg, cfg["model_config"])
    assert got == want
    assert (tmp_path / got).is_dir()
    if method == "unet":
        assert got == "checkpoints/UNet/resnet18/vv-vh_patches_3/RandomEvents"
    assert not os.path.isabs(got)


def test_unknown_method_raises():
    with pytest.raises(FileNotFoundError, match="no method config"):
        tcfg.load_config(method="nope", config_root=CONFIGS)
