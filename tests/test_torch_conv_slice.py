"""Port parity of the conv-route slice as a whole: one f32 UNet-ResNet18
train step with both conv kernel routes on (``conv_bn_kernel``: B6,
``dw_kernel``: B7) against the JAX train step with ``KUROSIWO_PALLAS_CONV``
and ``KUROSIWO_PALLAS_DW`` set to ``interpret`` (the Pallas kernels in
interpret mode), from the same weights, batch and learning rate 1e-3, on the
CPU (the plain versions of the port's kernels).

The JAX UNet runs with ``phase_finale=False``, the port's decoder: the JAX
default reparameterizes DecoderBlock_0's first conv into a folded one that
no kernel route takes (7 B6 and 4 B7 calls), where the standard decoder
routes 8 and 5 of the same function's convs.

Bands as tests/test_torch_steps.py (ROADMAP C6): loss rtol 1e-4; parameters
all within 2*lr and 99% within 3e-4; Adam's first moment (the gradient)
within 5% of each tensor's largest value and 2% in relative L2 norm; batch
statistics atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.models.factory import initialize_segmentation_model as t_init_model
from kurosiwo_torch.ops import conv_bn, conv_dw
from kurosiwo_torch.ops.losses import create_loss as t_create_loss
from kurosiwo_torch.ops.metrics import MetricState as TMetricState
from kurosiwo_torch.ops.nn import ConvBNAct
from kurosiwo_torch.training.state import create_train_state as t_create_state
from kurosiwo_torch.training.steps import make_eval_step as t_eval_step
from kurosiwo_torch.training.steps import make_train_step as t_train_step
from kurosiwo_tpu.models.unet import UNet as JaxUNet
from kurosiwo_tpu.ops import optim as j_optim
from kurosiwo_tpu.ops.losses import create_loss as j_create_loss
from kurosiwo_tpu.ops.metrics import MetricState as JMetricState
from kurosiwo_tpu.training.state import create_train_state as j_create_state
from kurosiwo_tpu.training.steps import make_train_step as j_train_step
from torch_step_parity import assert_adam_step_close, assert_first_moment_close

torch.set_num_threads(2)

CFG = {
    "task": "segmentation", "method": "unet", "num_classes": 3,
    "inputs": ["pre_event_1", "pre_event_2", "post_event"], "channels": ["vv", "vh"],
    "num_channels": 6, "weighted": True, "loss_function": "cross_entropy",
    "class_weights": [0.3715753140309927, 14.009780283125977, 8.20405370357821],
    "batch_size": 2, "optimizer": "adam", "learning_rate": 1e-3, "mixed_precision": False,
    "dem": False, "fused_tail": False,
}
ROUTES = {"conv_bn_kernel": True, "dw_kernel": True}
MCFG = {"backbone": "resnet18", "learning_rate": 1e-3}
LR = 1e-3


def _batch(seed):
    rs = np.random.RandomState(seed)
    b = {k: rs.randn(2, 64, 64, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["mask"] = rs.randint(0, 4, (2, 64, 64)).astype(np.int32)
    return b


def _tree(x):
    return jax.tree.map(np.asarray, dict(x))


@pytest.fixture(scope="module")
def jax_run():
    """Initial variables and the JAX results of one train step with both
    Pallas conv routes in interpret mode."""
    batch = _batch(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUROSIWO_PALLAS_CONV", "interpret")
        mp.setenv("KUROSIWO_PALLAS_DW", "interpret")
        model = JaxUNet(num_classes=3, phase_finale=False)
        tx = j_optim.create_optimizer(CFG, MCFG, "segmentation")
        x0 = jnp.zeros((2, 64, 64, 6), jnp.float32)
        state, _ = jax.jit(lambda key: j_create_state(model, tx, key, (x0,)))(
            jax.random.PRNGKey(0))
        init = {"params": _tree(state.params), "batch_stats": _tree(state.batch_stats)}
        step = jax.jit(j_train_step(model, tx, j_create_loss(CFG, "train"), CFG, MCFG,
                                    "segmentation"))
        new_state, _, loss = step(state, jax.tree.map(jnp.asarray, batch), JMetricState.create(),
                                  jnp.asarray(LR, jnp.float32), jax.random.PRNGKey(1))
    return {
        "init": init, "batch": batch, "loss": float(loss),
        "params": _tree(new_state.params), "batch_stats": _tree(new_state.batch_stats),
        "mu": _tree(new_state.opt_state.inner_state[0].mu),
    }


@pytest.fixture
def routed(monkeypatch):
    """Counts of the B6 and B7 functions the port's routes call."""
    calls = {"conv_bn": 0, "dw": 0}
    real_bn, real_dw = conv_bn.conv3x3_bn_stats, conv_dw.conv3x3_dw

    def bn(*a):
        calls["conv_bn"] += 1
        return real_bn(*a)

    def dw(*a):
        calls["dw"] += 1
        return real_dw(*a)

    monkeypatch.setattr(conv_bn, "conv3x3_bn_stats", bn)
    monkeypatch.setattr(conv_dw, "conv3x3_dw", dw)
    return calls


def _model(init, cfg):
    model = t_init_model(cfg, MCFG, device="cpu")
    model.load_state_dict(flax_to_torch(init))
    return model


def test_routed_train_step_matches_jax(jax_run, routed):
    cfg = dict(CFG, **ROUTES)
    model = _model(jax_run["init"], cfg)
    state = t_create_state(model, cfg, MCFG)
    step = t_train_step(model, t_create_loss(cfg, "train"), cfg, MCFG, device="cpu")
    state, ms, loss = step(state, jax_run["batch"], TMetricState.create(), LR)
    assert routed == {"conv_bn": 8, "dw": 5}
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=1e-4)
    assert float(ms.cm.sum()) == float((jax_run["batch"]["mask"] != 3).sum())
    tree = torch_to_flax(model.state_dict())
    assert_adam_step_close(tree["params"], jax_run["params"], LR)
    mu = {name: state.optimizer.state[p]["exp_avg"] for name, p in model.named_parameters()}
    assert_first_moment_close(torch_to_flax(mu)["params"], jax_run["mu"])
    for g, w in zip(jax.tree.leaves(tree["batch_stats"]), jax.tree.leaves(jax_run["batch_stats"])):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_routes_are_off_by_default(jax_run, routed):
    model = _model(jax_run["init"], CFG)
    assert not any(m.conv_bn_kernel or m.dw_kernel for m in model.modules()
                   if isinstance(m, ConvBNAct))
    state = t_create_state(model, CFG, MCFG)
    step = t_train_step(model, t_create_loss(CFG, "train"), CFG, MCFG, device="cpu")
    _, _, loss = step(state, jax_run["batch"], TMetricState.create(), LR)
    assert routed == {"conv_bn": 0, "dw": 0}
    # the same function as the routed step
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=1e-4)


def test_eval_takes_no_route(jax_run, routed):
    cfg = dict(CFG, **ROUTES)
    model = _model(jax_run["init"], cfg)
    assert sum(m.conv_bn_kernel for m in model.modules() if isinstance(m, ConvBNAct)) == 8
    ev = t_eval_step(model, t_create_loss(cfg, "val"), cfg, MCFG, device="cpu")
    ms, loss, _ = ev(None, jax_run["batch"], TMetricState.create())
    assert routed == {"conv_bn": 0, "dw": 0}
    assert np.isfinite(float(loss)) and float(ms.count) == 2.0
