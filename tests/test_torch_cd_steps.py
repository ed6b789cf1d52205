"""Port parity of the change-detection steps: one train step and one eval
step of kurosiwo_torch.training.steps (task "cd") against
kurosiwo_tpu.training.steps, per method (SNUNet-ECAM at base_channel 8,
Siam-diff and Siam-conc at 36x36 with JAX's dropout masks fed to the port,
ADHR-CDNet), from the same weights and batch, in f32 on the CPU, with each
method's shipped optimizer (learning rate 1e-3): Adam with optax's default
betas for SNUNet and Siam, SGD with momentum and weight decay for ADHR. The
explicit fused CE + confusion-matrix tail (B2's plain version here, JAX's
Pallas kernel in interpret mode) on SNUNet. Then the optimizer choice
against optax's over two steps, and the two-frame input assembly.

Bands (ROADMAP C6, as tests/test_torch_steps.py): loss rtol 1e-4; confusion
matrix row sums equal and each cell within 0.1% of the valid pixels; Adam's
parameters all within 2*lr and 99% within 3e-4 and its first moment within
5% of each tensor's largest value and 2% in L2, with a floor of 1e-6 of the
largest gradient for the gradients that are rounding noise of an exact zero
(torch_cd_parity.assert_gradients_close); SGD's momentum buffer (ADHR's
gradient plus the decay) in the same bands but at 8% of each tensor's
largest value: its ~100 BatchNorm + ReLU layers put more ReLU near-ties
(C6) in the way, and the worst tensor of four batches was at 5.3% (its L2
at 0.7%), a different tensor on each batch; its parameters within lr times
that band (with its floor) and one ulp; batch statistics atol 1e-4.
The optimizer updates of given gradients: rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_cd_parity as cdp
from kurosiwo_torch.config import load_json5
from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.ops.losses import create_loss as t_create_loss
from kurosiwo_torch.ops.metrics import MetricState as TMetricState
from kurosiwo_torch.ops.optim import create_optimizer as t_create_optimizer
from kurosiwo_torch.training.state import create_train_state as t_create_state
from kurosiwo_torch.training.steps import assemble_cd_inputs
from kurosiwo_torch.training.steps import make_eval_step as t_eval_step
from kurosiwo_torch.training.steps import make_train_step as t_train_step
from kurosiwo_tpu.ops import optim as j_optim
from kurosiwo_tpu.ops.losses import create_loss as j_create_loss
from kurosiwo_tpu.ops.metrics import MetricState as JMetricState
from kurosiwo_tpu.training import steps as j_steps
from kurosiwo_tpu.training.state import TrainState as JTrainState
from torch_step_parity import assert_adam_step_close

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

CW = [0.3715753140309927, 14.009780283125977, 8.20405370357821]
LR = 1e-3
CASES = [("snunet", False), ("snunet", True), ("siam-diff", False), ("siam-conc", False),
         ("adhr-cdnet", False)]


def method_config(method: str) -> dict:
    """The shipped configs/method file at lr 1e-3 (SNUNet at base_channel 8)."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent / "configs" / "method" / method
    mc = load_json5(root / (method.replace("-", "_") + ".json"))
    return {**mc, "learning_rate": LR, **(cdp.MCFG if method == "snunet" else {})}


def step_config(method: str, fused: bool) -> dict:
    return cdp.config(method, class_weights=CW, weighted=True, loss_function="cross_entropy",
                      fused_tail=fused, log_zone_metrics=False)


def batch(method: str, seed: int, sample_weight=None) -> dict:
    rs = np.random.RandomState(seed)
    s = cdp.SIZES[method]
    b = {k: rs.randn(2, s, s, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["mask"] = rs.randint(0, 4, (2, s, s)).astype(np.int32)
    if sample_weight is not None:
        b["sample_weight"] = np.asarray(sample_weight, np.float32)
    return b


def _find(node, attr):
    """The first ``attr`` (Adam's ``mu``, SGD's ``trace``) in an optax state."""
    if hasattr(node, attr):
        return getattr(node, attr)
    for child in (node.inner_state,) if hasattr(node, "inner_state") else (
            node if isinstance(node, tuple) else ()):
        found = _find(child, attr)
        if found is not None:
            return found
    return None


@pytest.fixture(scope="module", params=CASES, ids=[f"{m}{'-fused' if f else ''}" for m, f in CASES])
def jax_run(request):
    method, fused = request.param
    cfg, mcfg = step_config(method, fused), method_config(method)
    v = cdp.variables(method)
    model = cdp.j_init(cfg, mcfg)
    tx = j_optim.create_optimizer(cfg, mcfg, "cd")
    params = jax.tree.map(jnp.asarray, v["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                        opt_state=tx.init(params))
    train_batch, eval_batch = batch(method, 0), batch(method, 1, sample_weight=[1.0, 0.0])
    real = jax.device_count
    jax.device_count = lambda *a, **k: 1  # the fused tail needs one device; conftest forces 8
    try:
        step = j_steps.make_train_step(model, tx, j_create_loss(cfg, "train"), cfg, mcfg, "cd")
        with cdp.recorded_jax_masks() as masks:
            run = step if method.startswith("siam") else jax.jit(step)  # eager: concrete masks
            new_state, ms, loss = run(state, jax.tree.map(jnp.asarray, train_batch),
                                      JMetricState.create(), jnp.asarray(LR, jnp.float32),
                                      jax.random.PRNGKey(1))
        ev = jax.jit(j_steps.make_eval_step(model, j_create_loss(cfg, "val"), cfg, mcfg, "cd"))
        ems, eloss, _ = ev(new_state, jax.tree.map(jnp.asarray, eval_batch),
                           JMetricState.create())
    finally:
        jax.device_count = real
    sgd = mcfg["optimizer"] == "sgd"
    return {"method": method, "cfg": cfg, "mcfg": mcfg, "v": v, "masks": list(masks),
            "batch": train_batch, "eval_batch": eval_batch, "sgd": sgd,
            "loss": float(loss), "cm": np.asarray(ms.cm),
            "params": cdp.tree(new_state.params), "batch_stats": cdp.tree(new_state.batch_stats),
            "moment": cdp.tree(_find(new_state.opt_state, "trace" if sgd else "mu")),
            "eval_loss": float(eloss), "eval_cm": np.asarray(ems.cm)}


def _model(run, variables):
    model = cdp.t_init(run["cfg"], run["mcfg"], device="cpu")
    model.load_state_dict(flax_to_torch(variables))
    return model


def _assert_cm_close(got, want, mask):
    valid = int((np.asarray(mask) != 3).sum())
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert np.abs(got - want).max() <= 1e-3 * valid


def test_train_step_matches_jax(jax_run):
    run = jax_run
    model = _model(run, run["v"])
    state = t_create_state(model, run["cfg"], run["mcfg"], task="cd")
    assert isinstance(state.optimizer, torch.optim.SGD if run["sgd"] else torch.optim.Adam)
    step = t_train_step(model, t_create_loss(run["cfg"], "train"), run["cfg"], run["mcfg"],
                        task="cd", device="cpu")
    with cdp.fed_masks(run["masks"]):
        state, ms, loss = step(state, run["batch"], TMetricState.create(), LR)
    assert state.step == 1
    np.testing.assert_allclose(float(loss), run["loss"], rtol=1e-4)
    _assert_cm_close(ms.cm.numpy(), run["cm"], run["batch"]["mask"])
    tree = torch_to_flax(model.state_dict())
    key = "momentum_buffer" if run["sgd"] else "exp_avg"
    moment = {name: state.optimizer.state[p][key] for name, p in model.named_parameters()}
    moment = torch_to_flax(moment)["params"]
    cdp.assert_gradients_close(moment, run["moment"], rel=8e-2 if run["sgd"] else 5e-2)
    if run["sgd"]:  # p - lr * buffer: the buffer's band (and floor) times lr
        top = max(np.abs(m).max() for m in jax.tree.leaves(run["moment"]))
        for g, w, m in zip(jax.tree.leaves(tree["params"]), jax.tree.leaves(run["params"]),
                           jax.tree.leaves(run["moment"])):
            ulp = np.spacing(np.abs(w).max())  # the update's rounding
            assert np.abs(g - w).max() <= LR * max(8e-2 * np.abs(m).max(), 1e-6 * top) + ulp
    else:
        assert_adam_step_close(tree["params"], run["params"], LR)
    for g, w in zip(jax.tree.leaves(tree["batch_stats"]), jax.tree.leaves(run["batch_stats"])):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_eval_step_matches_jax(jax_run):
    run = jax_run
    model = _model(run, {"params": run["params"], "batch_stats": run["batch_stats"]})
    ev = t_eval_step(model, t_create_loss(run["cfg"], "val"), run["cfg"], run["mcfg"], task="cd",
                     device="cpu")
    ms, loss, _ = ev(None, run["eval_batch"], TMetricState.create())
    np.testing.assert_allclose(float(loss), run["eval_loss"], rtol=1e-4)
    eb = run["eval_batch"]
    _assert_cm_close(ms.cm.numpy(), run["eval_cm"],
                     np.where(eb["sample_weight"][:, None, None] > 0, eb["mask"], 3))
    assert float(ms.count) == 1.0


@pytest.mark.parametrize("method,cfg,want", [
    ("snunet", {"optimizer": "adam", "betas": [0.9, 0.009]}, "adam"),   # betas not read
    ("siam-diff", {"optimizer": "adamw", "betas": [0.8, 0.99], "weight_decay": 1e-2}, "adamw"),
    ("adhr-cdnet", {"optimizer": "sgd", "momentum": 0.9, "weight_decay": 5e-4}, "sgd"),
    ("hfa-net", {"optimizer": "adam", "momentum": 0.8, "weight_decay": 1e-5}, "sgd"),  # forced
    ("bit-cd", {"optimizer": "adam"}, "sgd"),  # forced, momentum 0.9, no decay
])
def test_cd_optimizer_choice_matches_optax(method, cfg, want):
    """Two updates of given gradients from the port's optimizer and from
    the JAX package's optax chain for the same config."""
    mcfg = {**cfg, "learning_rate": 1e-2}
    config = {"method": method}
    rs = np.random.RandomState(0)
    p0 = rs.randn(3, 4).astype(np.float32)
    grads = [rs.randn(3, 4).astype(np.float32) for _ in range(2)]
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = t_create_optimizer([p], config, mcfg, task="cd")
    kind = {torch.optim.Adam: "adam", torch.optim.AdamW: "adamw", torch.optim.SGD: "sgd"}
    assert kind[type(opt)] == want
    tx = j_optim.create_optimizer(config, mcfg, "cd")
    jp, jstate = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        upd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("inputs,dem", [(["pre_event_1", "post_event"], False),
                                        (["post_event", "pre_event_2"], True)])
def test_cd_inputs_are_assembled_as_jax(inputs, dem):
    rs = np.random.RandomState(0)
    b = {k: rs.randn(2, 4, 4, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["dem"] = rs.randn(2, 4, 4, 1).astype(np.float32)
    cfg = {"inputs": inputs, "dem": dem}
    got = assemble_cd_inputs({k: torch.from_numpy(v) for k, v in b.items()}, cfg)
    want = j_steps.assemble_cd_inputs({k: jnp.asarray(v) for k, v in b.items()}, cfg)
    for g, w in zip(got, want):
        assert g.shape[-1] == 2 + dem
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="exactly 2 inputs"):
        assemble_cd_inputs(b, {"inputs": ["post_event"]})


def test_recurrent_task_names_a7():
    """A7 (the recurrent task) is ported: its train and eval steps build and
    run a tiny ConvLSTM on the frames (pre2, pre1, post); a task the steps
    do not have still raises, naming theirs."""
    from kurosiwo_torch.models.factory import initialize_recurrent_model

    cfg = dict(cdp.config("snunet"), task="segmentation", method="convlstm",
               inputs=["pre_event_1", "pre_event_2", "post_event"], fused_tail=False)
    model = initialize_recurrent_model(cfg, {}, device="cpu")
    state = t_create_state(model, cfg, {"learning_rate": 1e-3})
    batch = cdp.step_batch("snunet", 0)
    step = t_train_step(model, t_create_loss(cfg, "train"), cfg, {}, task="recurrent",
                        device="cpu")
    state, ms, loss = step(state, batch, TMetricState.create(), 1e-3)
    ev = t_eval_step(model, t_create_loss(cfg, "val"), cfg, {}, task="recurrent", device="cpu")
    ems, eloss, _ = ev(state, batch, TMetricState.create())
    assert state.step == 1 and np.isfinite([float(loss), float(eloss)]).all()
    assert float(ms.cm.sum()) == float(ems.cm.sum()) == float((batch["mask"] != 3).sum())
    with pytest.raises(NotImplementedError, match="have no task 'mae'"):
        t_train_step(torch.nn.Identity(), None, {}, {}, task="mae", device="cpu")
