"""The losses of the port's create_loss (kurosiwo_torch.ops.losses), the
per-zone metric banks (ops.metrics) and the whole UNet train and eval steps
with each loss and with log_zone_metrics, against the JAX package's.

Exactness classes (ROADMAP C5): the losses and their gradients
cross-framework banded in f32 on the CPU (rtol 1e-5 with an atol of 1e-6 of
the largest gradient: the same f32 formulas, summed in other orders); the
zone banks bit-exact (integer counts); the steps banded as
tests/test_torch_steps.py, at its (2, 64, 64, 6) batch (tests/torch_step_parity.py,
C6): loss rtol 1e-4, cm row sums equal and cells within 0.1% of the valid
pixels (argmax near-ties between the frameworks), parameters all
within 2*lr and 99% within 3e-4, Adam's first moment within 5% of each
tensor's largest value and 2% in L2, batch statistics atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.models.factory import initialize_segmentation_model as t_init_model
from kurosiwo_torch.ops import losses as tl
from kurosiwo_torch.ops.metrics import MetricState as TMetricState
from kurosiwo_torch.training.state import create_train_state as t_create_state
from kurosiwo_torch.training.steps import make_eval_step as t_eval_step
from kurosiwo_torch.training.steps import make_train_step as t_train_step
from kurosiwo_tpu.models.factory import initialize_segmentation_model as j_init_model
from kurosiwo_tpu.ops import losses as jl
from kurosiwo_tpu.ops import optim as j_optim
from kurosiwo_tpu.ops.metrics import MetricState as JMetricState
from kurosiwo_tpu.training.state import create_train_state as j_create_state
from kurosiwo_tpu.training.steps import make_eval_step as j_eval_step
from kurosiwo_tpu.training.steps import make_train_step as j_train_step
from torch_step_parity import assert_adam_step_close, assert_first_moment_close

torch.set_num_threads(2)

CW = [0.3715753140309927, 14.009780283125977, 8.20405370357821]


def _inputs(seed, shape=(2, 12, 10)):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(*shape, 3) * 2).astype(np.float32)
    labels = rs.randint(0, 4, shape).astype(np.int32)
    return logits, labels


# (name, the port's function, the JAX package's) with the arguments
# create_loss gives them
LOSSES = {
    "cross_entropy": (lambda x, y: tl.cross_entropy_loss(x, y, CW),
                      lambda x, y: jl.cross_entropy_loss(x, y, jnp.asarray(CW))),
    "dice_loss": (tl.dice_loss, jl.dice_loss),
    "smp_dice_loss": (tl.smp_dice_loss, jl.smp_dice_loss),
    "focal_loss": (lambda x, y: tl.focal_loss(x, y, alpha=CW, gamma=2.0),
                   lambda x, y: jl.focal_loss(x, y, alpha=jnp.asarray(CW), gamma=2.0)),
    "lovasz_softmax_loss": (tl.lovasz_softmax_loss, jl.lovasz_softmax_loss),
    "ce_and_dice_loss": (lambda x, y: tl.ce_and_dice_loss(x, y, CW),
                         lambda x, y: jl.ce_and_dice_loss(x, y, jnp.asarray(CW))),
}


def _value_and_grad(pair, logits, labels):
    tf, jf = pair
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tf(x, torch.from_numpy(labels))
    got.backward()
    want, wgrad = jax.value_and_grad(lambda z: jf(z, jnp.asarray(labels)))(jnp.asarray(logits))
    return got.item(), x.grad.numpy(), float(want), np.asarray(wgrad)


def _assert_close(got, gg, want, wg):
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(gg, wg, rtol=1e-5, atol=1e-6 * np.abs(wg).max())


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradient_match_jax(name, seed):
    logits, labels = _inputs(seed)
    if seed == 1:  # one class absent, and a sample all ignored
        labels = np.where(labels == 2, 0, labels)
        labels[1] = 3
    _assert_close(*_value_and_grad(LOSSES[name], logits, labels))


def test_lovasz_with_tied_errors_matches_jax():
    """Logits equal across pixels give runs of equal errors: the gradient
    then depends on the order among ties, JAX's stable argsort(-errors)."""
    rs = np.random.RandomState(2)
    logits = np.zeros((2, 6, 5, 3), np.float32)
    logits[..., 1] = rs.choice([0.0, 1.0], (2, 6, 5))
    labels = rs.randint(0, 4, (2, 6, 5)).astype(np.int32)
    got, gg, want, wg = _value_and_grad(LOSSES["lovasz_softmax_loss"], logits, labels)
    errors = np.abs((labels[..., None] == np.arange(3)) - jax.nn.softmax(logits))
    assert len(np.unique(errors)) <= 6  # ties
    _assert_close(got, gg, want, wg)


@pytest.mark.parametrize("name", ["cross_entropy", "iou", "dice", "focal", "ce+dice"])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_create_loss_matches_jax(name, mode):
    """The dispatch: the same function for each name and mode (focal with
    alpha = the class weights and gamma 2, no config file read)."""
    cfg = {"loss_function": name, "class_weights": CW}
    logits, labels = _inputs(3)
    pair = (tl.create_loss(cfg, mode), jl.create_loss(cfg, mode))
    _assert_close(*_value_and_grad(pair, logits, labels))


def test_losses_take_bf16_logits_in_f32():
    logits, labels = _inputs(4)
    x = torch.from_numpy(logits).to(torch.bfloat16)
    for name in ("iou", "dice", "focal", "ce+dice"):
        fn = tl.create_loss({"loss_function": name, "class_weights": CW}, "train")
        got = fn(x, torch.from_numpy(labels))
        assert got.dtype == torch.float32
        assert float(got) == float(fn(x.float(), torch.from_numpy(labels)))


def test_unknown_loss_raises():
    with pytest.raises(NotImplementedError, match="not supported"):
        tl.create_loss({"loss_function": "hinge"})


def test_zone_banks_match_jax():
    """MetricState.update with clz: the per-zone banks and the main bank as
    JAX's, a zone outside 1..3 counted in the main bank only."""
    rs = np.random.RandomState(5)
    preds = rs.randint(0, 3, (6, 9, 7)).astype(np.int32)
    labels = rs.randint(0, 4, (6, 9, 7)).astype(np.int32)
    clz = np.asarray([1, 2, 3, 3, 0, 1], np.int32)
    got, want = TMetricState.create(), JMetricState.create()
    for scale in (1.0, 0.5):
        got = got.update(torch.from_numpy(preds), torch.from_numpy(labels), torch.tensor(scale),
                         2.0, clz=torch.from_numpy(clz))
        want = want.update(jnp.asarray(preds), jnp.asarray(labels), jnp.asarray(scale), 2.0,
                           clz=jnp.asarray(clz))
    np.testing.assert_array_equal(got.zones.numpy(), np.asarray(want.zones))
    np.testing.assert_array_equal(got.cm.numpy(), np.asarray(want.cm))
    assert float(got.loss_sum) == float(want.loss_sum) and float(got.count) == float(want.count)
    t_sum, j_sum = got.summarize(), want.summarize()
    for z in range(3):
        for k in ("iou", "fscore", "accuracy"):
            np.testing.assert_array_equal(t_sum["zones"][z][k], np.asarray(j_sum["zones"][z][k]))


# -- whole steps ---------------------------------------------------------------

CFG = {
    "task": "segmentation", "method": "unet", "num_classes": 3,
    "inputs": ["pre_event_1", "pre_event_2", "post_event"], "channels": ["vv", "vh"],
    "num_channels": 6, "class_weights": CW, "weighted": True,
    "loss_function": "cross_entropy", "batch_size": 2, "optimizer": "adam",
    "learning_rate": 1e-3, "mixed_precision": False, "dem": False,
}
MCFG = {"backbone": "resnet18", "learning_rate": 1e-3}
LR = 1e-3
STEP_CONFIGS = {name: {"loss_function": name} for name in ("iou", "dice", "focal", "ce+dice")}
STEP_CONFIGS["zones"] = {"log_zone_metrics": True}


def _batch(seed, sample_weight=None):
    rs = np.random.RandomState(seed)
    b = {k: rs.randn(2, 64, 64, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["mask"] = rs.randint(0, 4, (2, 64, 64)).astype(np.int32)
    b["clz"] = np.asarray([2, 3], np.int32)
    if sample_weight is not None:
        b["sample_weight"] = np.asarray(sample_weight, np.float32)
    return b


def _tree(x):
    return jax.tree.map(np.asarray, dict(x))


@pytest.fixture(scope="module")
def jax_steps():
    """One JAX init, and for each config one JAX train step and one eval step
    of the trained state (the eval batch drops its second sample through
    sample_weight)."""
    batch, eval_batch = _batch(0), _batch(1, sample_weight=[1.0, 0.0])
    model = j_init_model(CFG, MCFG)
    tx = j_optim.create_optimizer(CFG, MCFG, "segmentation")
    x0 = jnp.zeros((2, 64, 64, 6), jnp.float32)
    state, _ = jax.jit(lambda key: j_create_state(model, tx, key, (x0,)))(jax.random.PRNGKey(0))
    out = {"init": {"params": _tree(state.params), "batch_stats": _tree(state.batch_stats)},
           "batch": batch, "eval_batch": eval_batch}
    for name, over in STEP_CONFIGS.items():
        cfg = dict(CFG, **over)
        step = jax.jit(j_train_step(model, tx, jl.create_loss(cfg, "train"), cfg, MCFG,
                                    "segmentation"))
        new, ms, loss = step(state, jax.tree.map(jnp.asarray, batch), JMetricState.create(),
                             jnp.asarray(LR, jnp.float32), jax.random.PRNGKey(1))
        ev = jax.jit(j_eval_step(model, jl.create_loss(cfg, "val"), cfg, MCFG, "segmentation"))
        ems, eloss, _ = ev(new, jax.tree.map(jnp.asarray, eval_batch), JMetricState.create())
        out[name] = {
            "loss": float(loss), "cm": np.asarray(ms.cm), "zones": np.asarray(ms.zones),
            "params": _tree(new.params), "batch_stats": _tree(new.batch_stats),
            "mu": _tree(new.opt_state.inner_state[0].mu),
            "eval_loss": float(eloss), "eval_cm": np.asarray(ems.cm),
            "eval_zones": np.asarray(ems.zones),
        }
    return out


def _assert_cm_close(got, want, mask):
    valid = int((np.asarray(mask) != 3).sum())
    np.testing.assert_array_equal(got.sum(axis=-1), want.sum(axis=-1))
    assert np.abs(got - want).max() <= 1e-3 * valid


@pytest.mark.parametrize("name", STEP_CONFIGS)
def test_train_and_eval_steps_match_jax(jax_steps, name):
    cfg = dict(CFG, **STEP_CONFIGS[name])
    want = jax_steps[name]
    model = t_init_model(cfg, MCFG, device="cpu")
    model.load_state_dict(flax_to_torch(jax_steps["init"]))
    state = t_create_state(model, cfg, MCFG)
    step = t_train_step(model, tl.create_loss(cfg, "train"), cfg, MCFG, device="cpu")
    state, ms, loss = step(state, jax_steps["batch"], TMetricState.create(), LR)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-4)
    mask = jax_steps["batch"]["mask"]
    _assert_cm_close(ms.cm.numpy(), want["cm"], mask)
    _assert_cm_close(ms.zones.numpy(), want["zones"], mask)
    assert ms.zones.any() == (name == "zones")
    tree = torch_to_flax(model.state_dict())
    assert_adam_step_close(tree["params"], want["params"], LR)
    mu = {n: state.optimizer.state[p]["exp_avg"] for n, p in model.named_parameters()}
    assert_first_moment_close(torch_to_flax(mu)["params"], want["mu"])
    for g, w in zip(jax.tree.leaves(tree["batch_stats"]), jax.tree.leaves(want["batch_stats"])):
        np.testing.assert_allclose(g, w, atol=1e-4)

    # the eval step of the JAX-trained weights
    model.load_state_dict(flax_to_torch({"params": want["params"],
                                         "batch_stats": want["batch_stats"]}))
    ev = t_eval_step(model, tl.create_loss(cfg, "val"), cfg, MCFG, device="cpu")
    ems, eloss, _ = ev(None, jax_steps["eval_batch"], TMetricState.create())
    np.testing.assert_allclose(float(eloss), want["eval_loss"], rtol=1e-4)
    eb = jax_steps["eval_batch"]
    bank_mask = np.where(eb["sample_weight"][:, None, None] > 0, eb["mask"], 3)
    _assert_cm_close(ems.cm.numpy(), want["eval_cm"], bank_mask)
    _assert_cm_close(ems.zones.numpy(), want["eval_zones"], bank_mask)
