"""Config keys the JAX segmentation step honours and the port's step does not
yet (ROADMAP C13): building the port's train or eval step with one of them
on raises NotImplementedError naming its ROADMAP item, instead of a step
that silently computes another function. The shipped configs keep every one
of them off, so they still build.
"""

import pytest

from kurosiwo_torch.bench import MODEL_CONFIG, build_config
from kurosiwo_torch.models.factory import initialize_segmentation_model
from kurosiwo_torch.ops.losses import create_loss
from kurosiwo_torch.training.steps import make_eval_step, make_train_step
from kurosiwo_tpu.config import load_config


@pytest.fixture(scope="module")
def model():
    return initialize_segmentation_model(build_config("unet", 2), MODEL_CONFIG, device="cpu",
                                         seed=0)


def build(step: str, model, cfg: dict):
    make = make_train_step if step == "train" else make_eval_step
    return make(model, create_loss(cfg, step if step == "train" else "val"), cfg, MODEL_CONFIG,
                device="cpu")


# (step, overrides, the key named in the error, its ROADMAP item): the JAX
# train step reads augmentations (steps.py:137, :178-182), remat (:144) and
# the zone banks (:231); the eval step the zone banks (:310). The eval
# step's eval_microbatch (:281) is ported: tests/test_torch_engine.py::
# test_chunked_eval_matches_jax_chunked_eval_step holds it to JAX's.
REFUSED = [
    ("train", {"data_augmentations": True}, "data_augmentations", "A1"),
    ("train", {"log_zone_metrics": True}, "log_zone_metrics", "A1"),
    ("eval", {"log_zone_metrics": True}, "log_zone_metrics", "A1"),
    ("train", {"remat": True}, "remat", "A4"),
]


@pytest.mark.parametrize("step,overrides,key,item", REFUSED,
                         ids=[f"{s}-{k}" for s, _, k, _ in REFUSED])
def test_step_refuses_a_key_it_does_not_honour(model, step, overrides, key, item):
    # the shipped files with the key turned on (data_augmentations merges
    # configs/augmentations/augmentation.json into "augmentations")
    cfg = load_config(method="unet", overrides=overrides)
    if key == "data_augmentations":
        assert cfg["augmentations"]
    with pytest.raises(NotImplementedError, match=rf"{key}.*ROADMAP\.md, {item}\)"):
        build(step, model, cfg)


@pytest.mark.parametrize("step", ["train", "eval"])
def test_shipped_configs_build_both_steps(model, step):
    cfg = load_config(method="unet")
    assert not cfg.get("data_augmentations") and not cfg.get("log_zone_metrics")
    assert callable(build(step, model, cfg))


@pytest.mark.parametrize("step,overrides", [
    ("train", {"data_augmentations": True, "augmentations": {}}),  # nothing to apply
    ("train", {"eval_microbatch": 4}),  # an eval-step key
    ("eval", {"remat": True}),  # a train-step key
    ("eval", {"data_augmentations": True}),
    ("eval", {"eval_microbatch": 0}),
])
def test_keys_the_jax_step_ignores_stay_accepted(model, step, overrides):
    cfg = dict(build_config("unet", 2), **overrides)
    assert callable(build(step, model, cfg))
