"""Port parity of the slice as a whole: one UNet-ResNet18 train step and one
eval step of kurosiwo_torch.training.steps against
kurosiwo_tpu.training.steps (train tail ``fused_tail="phase"``, the JAX
default on one TPU chip, Pallas in interpret mode), from the same weights,
batch and learning rate 1e-3, in f32 on the CPU.

Bands: loss rtol 1e-4; confusion-matrix row sums equal and each cell within
0.1% of the valid pixels (near-tie argmax flips between frameworks);
parameters atol 3e-4 (the band of tests/test_pallas_tail.py) for at least
99% of the elements and 2*lr for all, since Adam's first step is about
lr*sign(g) and a gradient whose sign differs between the frameworks moves
its parameter the other way (see assert_adam_step_close); Adam's first
moment, the gradient itself, within 5% of each tensor's largest value and 2%
in relative L2 norm (see assert_first_moment_close); batch statistics atol
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.models.factory import initialize_segmentation_model as t_init_model
from kurosiwo_torch.ops.losses import create_loss as t_create_loss
from kurosiwo_torch.ops.metrics import MetricState as TMetricState
from kurosiwo_torch.training.state import create_train_state as t_create_state
from kurosiwo_torch.training.steps import make_eval_step as t_eval_step
from kurosiwo_torch.training.steps import make_train_step as t_train_step
from kurosiwo_tpu.models.factory import initialize_segmentation_model as j_init_model
from kurosiwo_tpu.ops import optim as j_optim
from kurosiwo_tpu.ops.losses import create_loss as j_create_loss
from kurosiwo_tpu.ops.metrics import MetricState as JMetricState
from kurosiwo_tpu.training.state import create_train_state as j_create_state
from kurosiwo_tpu.training.steps import make_eval_step as j_eval_step
from kurosiwo_tpu.training.steps import make_train_step as j_train_step
from torch_step_parity import assert_adam_step_close, assert_first_moment_close

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CW = [0.3715753140309927, 14.009780283125977, 8.20405370357821]
CFG = {
    "task": "segmentation", "method": "unet", "num_classes": 3,
    "inputs": ["pre_event_1", "pre_event_2", "post_event"], "channels": ["vv", "vh"],
    "num_channels": 6, "class_weights": CW, "weighted": True,
    "loss_function": "cross_entropy", "batch_size": 2, "optimizer": "adam",
    "learning_rate": 1e-3, "mixed_precision": False, "dem": False,
}
MCFG = {"backbone": "resnet18", "learning_rate": 1e-3}
LR = 1e-3


def _batch(seed, sample_weight=None):
    rs = np.random.RandomState(seed)
    b = {k: rs.randn(2, 64, 64, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["mask"] = rs.randint(0, 4, (2, 64, 64)).astype(np.int32)
    if sample_weight is not None:
        b["sample_weight"] = np.asarray(sample_weight, np.float32)
    return b


def _tree(x):
    return jax.tree.map(np.asarray, dict(x))


@pytest.fixture(scope="module")
def jax_run():
    """Initial variables, and the JAX results of one train step and one eval
    step (the eval batch drops its second sample through sample_weight)."""
    cfg = dict(CFG, fused_tail="phase")
    batch = _batch(0)
    eval_batch = _batch(1, sample_weight=[1.0, 0.0])
    real = jax.device_count
    jax.device_count = lambda *a, **k: 1  # the fused tail needs one device; conftest forces 8
    try:
        model = j_init_model(cfg, MCFG)
        tx = j_optim.create_optimizer(cfg, MCFG, "segmentation")
        x0 = jnp.zeros((2, 64, 64, 6), jnp.float32)
        # jit: an eager flax init of the UNet takes several times longer
        state, _ = jax.jit(lambda key: j_create_state(model, tx, key, (x0,)))(
            jax.random.PRNGKey(0))
        init = {"params": _tree(state.params), "batch_stats": _tree(state.batch_stats)}
        step = jax.jit(j_train_step(model, tx, j_create_loss(cfg, "train"), cfg, MCFG,
                                    "segmentation"))
        jb = jax.tree.map(jnp.asarray, batch)
        new_state, ms, loss = step(state, jb, JMetricState.create(), jnp.asarray(LR, jnp.float32),
                                   jax.random.PRNGKey(1))
        ev = jax.jit(j_eval_step(model, j_create_loss(cfg, "val"), cfg, MCFG, "segmentation"))
        ems, eloss, _ = ev(new_state, jax.tree.map(jnp.asarray, eval_batch), JMetricState.create())
    finally:
        jax.device_count = real
    return {
        "init": init, "batch": batch, "eval_batch": eval_batch,
        "loss": float(loss), "cm": np.asarray(ms.cm),
        "params": _tree(new_state.params), "batch_stats": _tree(new_state.batch_stats),
        "mu": _tree(new_state.opt_state.inner_state[0].mu),
        "eval_loss": float(eloss), "eval_cm": np.asarray(ems.cm),
        "eval_count": float(ems.count), "eval_loss_sum": float(ems.loss_sum),
    }


def _torch_model(init, cfg):
    model = t_init_model(cfg, MCFG, device="cpu")
    model.load_state_dict(flax_to_torch(init))
    return model


def _assert_cm_close(got, want, mask):
    valid = int((np.asarray(mask) != 3).sum())
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert np.abs(got - want).max() <= 1e-3 * valid


def _assert_trees_close(got, want, atol):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=atol)


@pytest.mark.parametrize("tail", [True, False], ids=["fused", "plain"])
def test_train_step_matches_jax(jax_run, tail):
    cfg = dict(CFG, fused_tail=tail)
    model = _torch_model(jax_run["init"], cfg)
    state = t_create_state(model, cfg, MCFG)
    step = t_train_step(model, t_create_loss(cfg, "train"), cfg, MCFG, device="cpu")
    state, ms, loss = step(state, jax_run["batch"], TMetricState.create(), LR)
    assert state.step == 1
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=1e-4)
    _assert_cm_close(ms.cm.numpy(), jax_run["cm"], jax_run["batch"]["mask"])
    tree = torch_to_flax(model.state_dict())
    assert_adam_step_close(tree["params"], jax_run["params"], LR)
    mu = {name: state.optimizer.state[p]["exp_avg"] for name, p in model.named_parameters()}
    assert_first_moment_close(torch_to_flax(mu)["params"], jax_run["mu"])
    _assert_trees_close(tree["batch_stats"], jax_run["batch_stats"], atol=1e-4)


def _trained_model(jax_run, cfg):
    trained = {"params": jax_run["params"], "batch_stats": jax_run["batch_stats"]}
    return _torch_model(trained, cfg)


@pytest.mark.parametrize("tail", [True, False], ids=["fused", "plain"])
def test_eval_step_matches_jax(jax_run, tail):
    cfg = dict(CFG, fused_tail=tail)
    model = _trained_model(jax_run, cfg)
    ev = t_eval_step(model, t_create_loss(cfg, "val"), cfg, MCFG, device="cpu")
    ms, loss, _ = ev(None, jax_run["eval_batch"], TMetricState.create())
    np.testing.assert_allclose(float(loss), jax_run["eval_loss"], rtol=1e-4)
    mask = np.where(jax_run["eval_batch"]["sample_weight"][:, None, None] > 0,
                    jax_run["eval_batch"]["mask"], 3)
    _assert_cm_close(ms.cm.numpy(), jax_run["eval_cm"], mask)
    assert float(ms.count) == jax_run["eval_count"] == 1.0
    np.testing.assert_allclose(float(ms.loss_sum), jax_run["eval_loss_sum"], rtol=1e-4)


def test_f32_twin_eval_of_bf16_policy_model_matches_jax(jax_run):
    """The f32 twin: a bf16-policy model evaluated with dtype=float32 is the
    f32 function of the same parameters."""
    cfg = dict(CFG, mixed_precision=True, fused_tail=True)
    model = _trained_model(jax_run, cfg)
    assert model.dtype == torch.bfloat16
    ev = t_eval_step(model, t_create_loss(cfg, "val"), cfg, MCFG, device="cpu",
                     dtype=torch.float32, with_preds=True)
    ms, loss, aux = ev(None, jax_run["eval_batch"], TMetricState.create())
    np.testing.assert_allclose(float(loss), jax_run["eval_loss"], rtol=1e-4)
    assert aux["preds"].shape == (2, 64, 64)
    summary = ms.summarize()
    assert 0.0 <= summary["mean_iou"] <= 1.0
    np.testing.assert_allclose(summary["val_loss"], jax_run["eval_loss"], rtol=1e-4)


def test_bf16_train_step_runs_and_keeps_f32_masters(jax_run):
    cfg = dict(CFG, mixed_precision=True, fused_tail=True)
    model = _torch_model(jax_run["init"], cfg)
    state = t_create_state(model, cfg, MCFG)
    step = t_train_step(model, t_create_loss(cfg, "train"), cfg, MCFG, device="cpu")
    state, ms, loss = step(state, jax_run["batch"], TMetricState.create(), LR)
    # bf16 rounds at other points than f32: a loose band on the loss only
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert float(ms.cm.sum()) == float((jax_run["batch"]["mask"] != 3).sum())
