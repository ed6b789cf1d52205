"""Config keys the JAX segmentation step honours (ROADMAP C13, closed): building the
port's train or eval step with one the port does not honour yet raises
NotImplementedError naming its ROADMAP item, instead of a step that
silently computes another function; a key the port has since ported is
honoured by the step it builds. The shipped configs keep every one of them
off, so they still build.
"""

import numpy as np
import pytest
import torch

from kurosiwo_torch.bench import MODEL_CONFIG, build_config
from kurosiwo_torch.models.factory import initialize_segmentation_model
from kurosiwo_torch.ops.losses import create_loss
from kurosiwo_torch.ops.metrics import MetricState
from kurosiwo_torch.training.state import create_train_state
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


def _batch(seed=0, b=4, size=32):
    rs = np.random.RandomState(seed)
    batch = {k: rs.randn(b, size, size, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    batch["mask"] = rs.randint(0, 4, (b, size, size)).astype(np.int32)
    batch["valid"] = np.ones((b, size, size), np.int32)
    batch["clz"] = np.asarray([1, 2, 3, 1][:b], np.int32)
    batch["sample_weight"] = np.ones(b, np.float32)
    return batch


def _honoured(step, model, cfg, key):
    """The step built with ``key`` on does what the key asks: the train
    step with data_augmentations crops and flips the batch it trains on (a
    generator it is given draws them, so another seed gives another loss),
    both steps with log_zone_metrics fill zone banks that sum to the
    main bank, and the train step with remat ends where the step without
    it does, bitwise (tests/test_torch_remat.py holds every method's plan
    and that the forward does run again)."""
    cfg = dict(cfg, mixed_precision=False)
    fn = build(step, model, cfg)
    batch = _batch()
    if step == "train":
        state = create_train_state(model, cfg, MODEL_CONFIG)
        snapshot = {k: v.clone() for k, v in model.state_dict().items()}

        def run(seed):
            model.load_state_dict(snapshot)
            g = torch.Generator().manual_seed(seed)
            _, ms, loss = fn(state, batch, MetricState.create(), 1e-3, g)
            return ms, float(loss)

        ms, loss = run(0)
        if key == "remat":
            def after(c):
                model.load_state_dict(snapshot)
                st = create_train_state(model, c, MODEL_CONFIG)
                _, _, lo = build(step, model, c)(st, batch, MetricState.create(), 1e-3)
                return float(lo), {k: v.clone() for k, v in model.state_dict().items()}

            (with_loss, with_sd) = after(cfg)
            (plain_loss, plain_sd) = after(dict(cfg, remat=False))
            assert with_loss == plain_loss
            assert all(torch.equal(with_sd[k], plain_sd[k]) for k in plain_sd)
        if key == "data_augmentations":
            assert run(0)[1] == loss and run(1)[1] != loss
            with pytest.raises(ValueError, match="Generator"):
                fn(state, batch, MetricState.create(), 1e-3)
    else:
        ms, _, _ = fn(None, batch, MetricState.create())
    if key == "log_zone_metrics":
        zones = ms.zones.numpy()
        assert (zones.sum(axis=(1, 2)) > 0).all()
        np.testing.assert_array_equal(zones.sum(axis=0), ms.cm.numpy())


# (step, overrides, the key named, its ROADMAP item; None once ported): the
# JAX train step reads augmentations (steps.py:137, :178-182), remat (:144)
# and the zone banks (:231); the eval step the zone banks (:310). The
# augmentations and the zone banks are ported (A1; tests/test_torch_augment.py
# and tests/test_torch_losses.py hold them to JAX's), and so is remat (A6's
# ops/remat.py; tests/test_torch_remat.py). The eval
# step's eval_microbatch (:281) is ported: tests/test_torch_engine.py::
# test_chunked_eval_matches_jax_chunked_eval_step holds it to JAX's.
REFUSED = [
    ("train", {"data_augmentations": True}, "data_augmentations", None),
    ("train", {"log_zone_metrics": True}, "log_zone_metrics", None),
    ("eval", {"log_zone_metrics": True}, "log_zone_metrics", None),
    ("train", {"remat": True}, "remat", None),
]


@pytest.mark.parametrize("step,overrides,key,item", REFUSED,
                         ids=[f"{s}-{k}" for s, _, k, _ in REFUSED])
def test_step_refuses_a_key_it_does_not_honour(model, step, overrides, key, item):
    # the shipped files with the key turned on (data_augmentations merges
    # configs/augmentations/augmentation.json into "augmentations")
    cfg = load_config(method="unet", overrides=overrides)
    if key == "data_augmentations":
        assert cfg["augmentations"]
    if item is None:
        _honoured(step, model, cfg, key)
        return
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


# ChangeFormer's model-config keys, which the JAX step (multi_scale_train,
# steps.py:196-215; multi_scale_infer, :91-109) and model (tail_chunks,
# remat_ffn, changeformer.py:159-161, :272-331) honour, are ported (A6;
# tests/test_torch_cd_changeformer.py holds them to JAX's): the step built
# with each does what it asks
CF_KEYS = ["multi_scale_train", "multi_scale_infer", "tail_chunks", "remat_ffn"]


@pytest.mark.parametrize("key", CF_KEYS)
def test_changeformer_keys_are_honoured(monkeypatch, key):
    from kurosiwo_torch.models import changeformer as tcf
    from kurosiwo_torch.models.factory import initialize_cd_model
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.nn import resize_linear, resize_nearest

    cfg = dict(build_config("changeformer", 2), mixed_precision=False)
    weights = [0.5, 0.5, 0.5, 0.8, 1.0]
    mcfg = {"embed_dim": 16, "optimizer": "sgd", "learning_rate": 1e-3,
            "multi_pred_weights": weights, key: 2 if key == "tail_chunks" else True}
    model = initialize_cd_model(cfg, mcfg, device="cpu", seed=1)
    batch = _batch(b=2)
    x = (torch.from_numpy(batch["pre1"]), torch.from_numpy(batch["post"]))
    mask = torch.from_numpy(batch["mask"])
    crit = create_loss(cfg, "train")
    if key in ("multi_scale_train", "tail_chunks", "remat_ffn"):
        regions = []
        real = tcf.remat
        monkeypatch.setattr(tcf, "remat", lambda fn, *a: regions.append(1) or real(fn, *a))
        heads = model.train()(*x, generator=torch.Generator().manual_seed(0))
        want = (sum(w * crit(resize_linear(h, mask.shape[1:]), mask)
                    for w, h in zip(weights, heads))
                if key == "multi_scale_train" else crit(heads[-1], mask))
        state = create_train_state(model, cfg, mcfg, "cd")
        step = make_train_step(model, crit, cfg, mcfg, task="cd", device="cpu")
        regions.clear()
        _, _, loss = step(state, batch, MetricState.create(), 1e-3,
                          torch.Generator().manual_seed(0))
        assert float(loss) == float(want.detach())
        if key == "multi_scale_train":
            assert float(loss) != float(crit(heads[-1], mask))
        # remat_ffn: one region a Mix-FFN (13 blocks, 2 frames); tail_chunks: one a chunk
        assert len(regions) == {"multi_scale_train": 0, "tail_chunks": 2, "remat_ffn": 26}[key]
    else:
        ev = make_eval_step(model, create_loss(cfg, "val"), cfg, mcfg, task="cd", device="cpu")
        ms, _, _ = ev(None, batch, MetricState.create())
        with torch.no_grad():
            heads = model.eval()(*x)
        mean = sum(resize_nearest(h, mask.shape[1:]) for h in heads) / len(heads)
        want = MetricState.create().update(mean.argmax(-1), mask.int(), torch.tensor(0.0), 2.0)
        np.testing.assert_array_equal(ms.cm.numpy(), want.cm.numpy())
        assert not np.array_equal(ms.cm.numpy(), MetricState.create().update(
            heads[-1].argmax(-1), mask.int(), torch.tensor(0.0), 2.0).cm.numpy())
