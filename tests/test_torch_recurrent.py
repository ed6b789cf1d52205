"""The port's recurrent task (ConvLSTM N-to-1 segmentation) against the JAX
package's, on the CPU in f32 at a tiny size: frames of 2 channels at 32x32,
batch 2, T = 3. One jitted JAX run (``jax_run``) gives the forward, one
train step (plain Adam at lr 1e-3, RandomEvents-weighted cross entropy on
the model's probabilities) and the eval step of its result.

Exactness classes (ROADMAP C5):
- bit-exact: the flax<->torch round trip of the ConvLSTM tree; the input
  assembly; the GroupNorm's scale and bias names;
- cross-framework banded, f32: the forward within 5e-4; GroupNorm alone
  within 1e-5 forward and 1e-4 backward at mean 0; at a large mean, where
  E[x^2] - mean^2 (flax's fast variance) cancels digits in both, the
  port's distance from the exact (f64) value is at most twice flax's;
- the train and eval steps (C6): loss rtol 1e-4, the cm within 0.1% of the
  valid pixels, Adam's first moment and parameters as
  ``torch_step_parity``; the stages that reach nothing take zero gradients
  in both;
- within torch: ``fused_tail: true`` (B2's plain version on the CPU)
  against the plain tail, loss rtol 1e-6, the same cm, the parameters as
  ``torch_step_parity``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.models.factory import initialize_recurrent_model as t_init
from kurosiwo_torch.ops.losses import create_loss as t_create_loss
from kurosiwo_torch.ops.metrics import MetricState as TMetricState
from kurosiwo_torch.ops.nn import GroupNorm as TGroupNorm
from kurosiwo_torch.training.state import create_train_state as t_create_state
from kurosiwo_torch.training.steps import assemble_recurrent_input
from kurosiwo_torch.training.steps import make_eval_step as t_eval_step
from kurosiwo_torch.training.steps import make_train_step as t_train_step
from kurosiwo_tpu.models.factory import initialize_recurrent_model as j_init
from kurosiwo_tpu.training import steps as j_steps
from torch_cd_parity import assert_cm_close, jit_fast, tree
from torch_step_parity import assert_adam_step_close, assert_first_moment_close

torch.set_num_threads(2)

SIDE, B, LR = 32, 2, 1e-3
CW = [0.3715753140309927, 14.009780283125977, 8.20405370357821]
CFG = {"task": "segmentation", "method": "convlstm", "num_classes": 3, "num_channels": 2,
       "mixed_precision": False, "batch_size": B, "inputs": ["pre_event_1", "pre_event_2",
                                                           "post_event"],
       "dem": False, "class_weights": CW, "weighted": True, "loss_function": "cross_entropy",
       "fused_tail": False, "log_zone_metrics": False}
# the shipped model config: its optimizer and betas are not read by the task
MCFG = {"method": "convlstm", "optimizer": "adam", "momentum": 0.99, "learning_rate": LR,
        "weight_decay": 0.0, "betas": [0.9, 0.009], "lr_schedule": None}
# the stages whose outputs reach nothing (models/convlstm.py)
DEAD = ("conv_2e", "clstm_2e", "conv_3e", "clstm_3e", "clstm_1d", "clstm_2d")


def _batch(seed, sample_weight=None):
    rs = np.random.RandomState(seed)
    b = {k: rs.randn(B, SIDE, SIDE, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["mask"] = rs.randint(0, 4, (B, SIDE, SIDE)).astype(np.int32)
    if sample_weight is not None:
        b["sample_weight"] = np.asarray(sample_weight, np.float32)
    return b


def _variables(seed=0):
    """Flax variables from the port's seeded init, the GroupNorms' scale and
    bias perturbed so that they are not an identity."""
    v = torch_to_flax(t_init(CFG, MCFG, device="cpu", seed=seed).state_dict())
    rs = np.random.RandomState(seed + 100)
    for name, cell in v["params"].items():
        if "norm" in cell:
            n = cell["norm"]
            n["scale"] = (1 + 0.2 * rs.randn(*n["scale"].shape)).astype(np.float32)
            n["bias"] = (0.1 * rs.randn(*n["bias"].shape)).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def jax_run():
    from kurosiwo_tpu.ops import optim as j_optim
    from kurosiwo_tpu.ops.losses import create_loss
    from kurosiwo_tpu.ops.metrics import MetricState
    from kurosiwo_tpu.training.state import TrainState

    v = _variables()
    params = jax.tree.map(jnp.asarray, v["params"])
    model = j_init(CFG, MCFG)
    tx = j_optim.create_optimizer(CFG, MCFG, "segmentation")  # the JAX engine's choice
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params))
    step = j_steps.make_train_step(model, tx, create_loss(CFG, "train"), CFG, MCFG, "recurrent")
    ev = j_steps.make_eval_step(model, create_loss(CFG, "val"), CFG, MCFG, "recurrent")
    tb, eb = _batch(0), _batch(1, sample_weight=[1.0, 0.0])
    x = j_steps.assemble_recurrent_input(jax.tree.map(jnp.asarray, tb), CFG)

    def run(params, state, tb, eb, x):
        out = {"probs": model.apply({"params": params}, x)}
        new, ms, loss = step(state, tb, MetricState.create(), jnp.asarray(LR, jnp.float32),
                             jax.random.PRNGKey(0))
        out.update(loss=loss, cm=ms.cm, params=new.params, moment=new.opt_state.inner_state[0].mu)
        ems, eloss, _ = ev(new, eb, MetricState.create())
        out.update(eval_loss=eloss, eval_cm=ems.cm)
        return out

    res = jit_fast(run, params, state, jax.tree.map(jnp.asarray, tb),
                   jax.tree.map(jnp.asarray, eb), x)
    res = {k: tree(r) if isinstance(r, dict) else np.asarray(r) for k, r in res.items()}
    return {"v": v, "batch": tb, "eval_batch": eb, **res}


def _port(v):
    model = t_init(CFG, MCFG, device="cpu")
    model.load_state_dict(flax_to_torch(v))
    return model


def test_convlstm_tree_matches_jax_and_round_trips():
    shapes = jax.eval_shape(lambda: j_init(CFG, {}).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, SIDE, SIDE, 2), jnp.float32)))
    want = flax_to_torch(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes)))
    model = t_init(CFG, MCFG, device="cpu")
    state = model.state_dict()
    assert {k: tuple(t.shape) for k, t in state.items()} == {
        k: tuple(t.shape) for k, t in want.items()}
    assert "clstm_1e.norm.scale" in state and "transconv_3d.weight" in state
    assert not any(k.startswith(("transconv_1d", "transconv_2d")) for k in state)
    back = flax_to_torch(torch_to_flax(state))
    assert all(torch.equal(back[k], state[k]) for k in state)


def test_convlstm_forward_matches_jax(jax_run):
    x = assemble_recurrent_input({k: torch.from_numpy(v) for k, v in jax_run["batch"].items()},
                                 CFG)
    got = _port(jax_run["v"])(x)
    assert got.dtype == torch.float32 and got.shape == (B, SIDE, SIDE, 3)
    np.testing.assert_allclose(got.detach().numpy(), jax_run["probs"], atol=5e-4, rtol=0)
    np.testing.assert_allclose(got.sum(-1).detach().numpy(), 1.0, atol=1e-5)


def test_train_step_matches_jax(jax_run):
    model = _port(jax_run["v"])
    state = t_create_state(model, CFG, MCFG, "segmentation")
    step = t_train_step(model, t_create_loss(CFG, "train"), CFG, MCFG, task="recurrent",
                        device="cpu")
    state, ms, loss = step(state, jax_run["batch"], TMetricState.create(), LR)
    np.testing.assert_allclose(float(loss), float(jax_run["loss"]), rtol=1e-4)
    assert_cm_close(ms.cm.numpy(), jax_run["cm"], jax_run["batch"]["mask"])
    moment = torch_to_flax({n: state.optimizer.state[p]["exp_avg"]
                            for n, p in model.named_parameters()})["params"]
    assert_first_moment_close(moment, jax_run["moment"])
    assert_adam_step_close(torch_to_flax(model.state_dict())["params"], jax_run["params"], LR)
    # the stages that reach nothing: zero gradients, unchanged parameters, in both
    for name in DEAD:
        for leaf in jax.tree.leaves(jax_run["moment"][name]) + jax.tree.leaves(moment[name]):
            assert not np.any(leaf)
        for g, w in zip(jax.tree.leaves(torch_to_flax(model.state_dict())["params"][name]),
                        jax.tree.leaves(jax_run["v"]["params"][name])):
            np.testing.assert_array_equal(g, w)


def test_eval_step_matches_jax(jax_run):
    model = _port({"params": jax_run["params"]})
    ev = t_eval_step(model, t_create_loss(CFG, "val"), CFG, MCFG, task="recurrent", device="cpu")
    ms, loss, _ = ev(None, jax_run["eval_batch"], TMetricState.create())
    np.testing.assert_allclose(float(loss), float(jax_run["eval_loss"]), rtol=1e-4)
    eb = jax_run["eval_batch"]
    assert_cm_close(ms.cm.numpy(), jax_run["eval_cm"],
                    np.where(eb["sample_weight"][:, None, None] > 0, eb["mask"], 3))
    assert float(ms.count) == 1.0


def test_fused_tail_on_the_recurrent_step_is_the_plain_tail(jax_run):
    """``fused_tail: true`` is honoured on the recurrent step (B2's NHWC
    kernels on the f32 probabilities; their plain version here), the
    same loss and cm as the plain tail; "auto" keeps the plain tail."""
    from kurosiwo_torch.ops.fused_tail import resolve_fused_tail

    assert resolve_fused_tail(dict(CFG, fused_tail="auto"), "recurrent", MCFG,
                              device=torch.device("cuda")) is None
    out = {}
    for fused in (False, True):
        cfg = dict(CFG, fused_tail=fused)
        model = _port(jax_run["v"])
        state = t_create_state(model, cfg, MCFG, "segmentation")
        step = t_train_step(model, t_create_loss(cfg, "train"), cfg, MCFG, task="recurrent",
                            device="cpu")
        _, ms, loss = step(state, jax_run["batch"], TMetricState.create(), LR)
        out[fused] = (float(loss), ms.cm.numpy(), torch_to_flax(model.state_dict())["params"])
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    np.testing.assert_array_equal(out[True][1], out[False][1])
    assert_adam_step_close(out[True][2], out[False][2], LR)  # near-zero gradients flip (C6)


@pytest.mark.parametrize("mean", [0.0, 50.0], ids=["mean0", "large_mean"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_groupnorm_matches_flax(mean, dtype):
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 6, 5, 64) * 1.5 + mean).astype(np.float32)
    dy = rs.randn(2, 6, 5, 64).astype(np.float32)
    scale = (1 + 0.2 * rs.randn(64)).astype(np.float32)
    bias = (0.1 * rs.randn(64)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    gn = fnn.GroupNorm(num_groups=2, epsilon=1e-5, dtype=jdt)
    p = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    jx = jnp.asarray(x, jdt)
    y, vjp = jax.vjp(lambda p, xx: gn.apply(p, xx), p, jx)
    jgp, jgx = vjp(jnp.asarray(dy, jdt))

    mod = TGroupNorm(64, 2)
    mod.scale.data, mod.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ty = mod(tx, tdt)
    assert ty.dtype == tdt and set(dict(mod.named_parameters())) == {"scale", "bias"}
    ty.backward(torch.from_numpy(dy).to(tdt))
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    got, want = ty.detach().float().numpy(), f(y)
    if dtype == "bf16":  # one bf16 rounding of values up to ~4
        np.testing.assert_allclose(got, want, atol=4e-2, rtol=0)
        np.testing.assert_allclose(tx.grad.float().numpy(), f(jgx), atol=6e-2, rtol=0)
        return
    if mean == 0.0:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tx.grad.numpy(), f(jgx), atol=1e-4, rtol=0)
        np.testing.assert_allclose(mod.scale.grad.numpy(), f(jgp["params"]["scale"]), atol=1e-4)
        np.testing.assert_allclose(mod.bias.grad.numpy(), f(jgp["params"]["bias"]), atol=1e-4)
        return
    # the exact function in f64 (two-pass variance): both f32 results lose
    # digits to E[x^2] - mean^2, the port no more than twice what flax loses
    xg = x.astype(np.float64).reshape(2, 30, 2, 32)
    mu, var = xg.mean((1, 3), keepdims=True), xg.var((1, 3), keepdims=True)
    exact = ((xg - mu) / np.sqrt(var + 1e-5) * scale.reshape(2, 32) + bias.reshape(2, 32))
    exact = exact.reshape(x.shape)
    flax_err = np.abs(want - exact).max()
    assert flax_err > 1e-5  # the fast variance does lose digits at this mean
    assert np.abs(got - exact).max() <= 2 * flax_err + 1e-6


@pytest.mark.parametrize("dem", [False, True])
def test_recurrent_input_is_assembled_as_jax(dem):
    rs = np.random.RandomState(0)
    b = {k: rs.randn(2, 4, 4, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["dem"] = rs.randn(2, 4, 4, 1).astype(np.float32)
    cfg = {"dem": dem}
    got = assemble_recurrent_input({k: torch.from_numpy(v) for k, v in b.items()}, cfg)
    want = j_steps.assemble_recurrent_input({k: jnp.asarray(v) for k, v in b.items()}, cfg)
    assert got.shape == (2, 3, 4, 4, 2 + dem)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, 0, ..., :2].numpy(), b["pre2"])  # (pre2, pre1, post)


def _engine_cfg(tmp_path, **kw):
    return {**CFG, "root_path": str(tmp_path / "none"), "synthetic_data": True,
            "synthetic_size": 4, "synthetic_patch_size": SIDE, "epochs": 1, "num_workers": 2,
            "print_frequency": 1000, "on_screen_prints": False, "wandb_activate": False,
            "log_AOI_metrics": False, "evaluate_water": True, "oversampling": False,
            "track": "RandomEvents", "channels": ["vv", "vh"], "clamp_input": 0.15,
            "scale_input": "normalize", "data_mean": [0.0953, 0.0264],
            "data_std": [0.0427, 0.0215], "data_augmentations": False,
            "train_acts": [130], "val_acts": [514], "test_acts": [321],
            "train_save_checkpoint_freq": 1, "checkpoint_path": str(tmp_path / "run"), **kw}


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_recurrent_engine_takes_plain_adam(tmp_path, optimizer):
    """Plain Adam (0.9, 0.999) at the model config's lr, whatever its
    ``optimizer`` and ``betas`` say, as the JAX engine (engine.py:90-92)."""
    from kurosiwo_torch.training.engine import TaskEngine
    from kurosiwo_tpu.ops import optim as j_optim

    mcfg = dict(MCFG, optimizer=optimizer)
    engine = TaskEngine(t_init(CFG, mcfg, device="cpu"), _engine_cfg(tmp_path), mcfg,
                        "recurrent", 1, device="cpu")
    opt = engine.state.optimizer
    assert type(opt) is torch.optim.Adam and len(opt.param_groups) == 1
    assert opt.param_groups[0]["betas"] == (0.9, 0.999) and opt.param_groups[0]["lr"] == LR
    tx = j_optim.create_optimizer(CFG, mcfg, "segmentation")
    hp = tx.init({"w": jnp.zeros(2)}).hyperparams
    assert float(hp["b2"]) == pytest.approx(0.999) and float(hp["learning_rate"]) == pytest.approx(LR)


def test_recurrent_engine_epoch_saves_checkpoint_epoch(tmp_path):
    """One engine epoch of the recurrent task: a finite loss, val, best and
    latest, and ``checkpoint_epoch=0`` (train_save_checkpoint_freq 1, as
    change detection); the test eval restores to the trained weights."""
    from kurosiwo_torch.data.pipeline import prepare_loaders
    from kurosiwo_torch.training.checkpoint import CheckpointManager
    from kurosiwo_torch.training.recurrent import (eval_recurrent_segmentation,
                                                   train_recurrent_segmentation)

    cfg = _engine_cfg(tmp_path)
    tr, va, te = prepare_loaders(cfg, seed=1)
    try:
        engine = train_recurrent_segmentation(t_init(cfg, MCFG, device="cpu"), tr, va, te, cfg,
                                              MCFG, seed=1, device="cpu")
        acc, f1, miou = eval_recurrent_segmentation(engine, te)
    finally:
        for loader in (tr, va, te):
            loader.close()
    assert 0.0 <= miou <= 100.0 and np.isfinite([acc, f1]).all()
    ckpt = CheckpointManager(cfg["checkpoint_path"])
    assert ckpt.has("checkpoint_epoch=0") and ckpt.has("latest")
    payload, _ = ckpt.load("checkpoint_epoch=0")
    assert payload["step"] == len(tr) and "clstm_3d.norm.scale" in payload["model"]


def test_recurrent_learns(tmp_path):
    """tests/test_learning.py's recurrent check on the port alone: 8 epochs
    of a 2-step split, the last epoch's mean loss below the first's."""
    from kurosiwo_torch.data.pipeline import Loader
    from kurosiwo_torch.training.engine import TaskEngine

    cfg = _engine_cfg(tmp_path, batch_size=8, synthetic_size=16, synthetic_patch_size=64,
                      weighted=False, class_weights=[1.0, 1.0, 1.0])
    mcfg = {"learning_rate": 1e-3, "lr_schedule": None, "optimizer": "adam"}
    tr = Loader("train", cfg, 1)
    try:
        engine = TaskEngine(t_init(cfg, mcfg, device="cpu", seed=1), cfg, mcfg, "recurrent",
                            len(tr), device="cpu", seed=1)
        losses = [engine.run_train_epoch(tr, e)["mean_loss"] for e in range(8)]
    finally:
        tr.close()
    assert np.isfinite(losses).all() and losses[-1] < losses[0], json.dumps(losses)


def test_convlstm_bench_leg_is_the_unet_bench_config_with_three_frames():
    """``bench --model convlstm``: the repository's UNet bench config
    (bench.py:167-188) with the method swapped in and one frame's 2
    channels a model input; its steps are the recurrent task's, its
    optimizer plain Adam."""
    import bench as jax_bench

    from kurosiwo_torch import bench

    cfg = bench.build_config("convlstm", 128)
    assert cfg == dict(jax_bench.build_config("unet", 128), method="convlstm", num_channels=2)
    b = bench.setup(2, model="convlstm", device="cpu")
    assert b.task == "recurrent" and type(b.state.optimizer) is torch.optim.Adam
    assert b.batch["post"].shape == (2, 224, 224, 2)
