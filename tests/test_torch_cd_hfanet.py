"""Port parity of HFA-Net (kurosiwo_torch.models.hfanet) against
kurosiwo_tpu's, at the one input size the model fits (224x224; batch 1, two
2-channel frames), the same weights carried through kurosiwo_torch.convert:
names and shapes against the flax tree (its auto-names included), the eval
and train-mode outputs with the updated running statistics, the bridge's
round trip, and one train step with the optimizer HFA-Net is forced to
(SGD, momentum 0.9, weight decay 1e-5; the shipped config, lr 1e-3).

Exactness classes (ROADMAP C5): the bridge bit-exact; outputs and
statistics cross-framework banded in f32 on the CPU at atol 5e-4; the step
at tests/test_torch_cd_steps.py's bands (loss rtol 1e-4; the momentum
buffer, the gradient plus the decay, within 5% of each tensor's largest
value and 2% in L2 (torch_cd_parity.assert_gradients_close); the
parameters within lr times that band and one ulp), with the floor for small gradients
at 1e-3 of the largest gradient in place of 1e-6: HFA-Net's spatial
attention masks end in a one-channel BatchNorm and a sigmoid, whose
gradients (1e-7 to 1e-4, against 1.3e-2 for the largest) are differences of
far larger terms. Measured on this batch: 9 of 1,382 tensors outside the 5%
band, all such small ones, the worst at 7.9e-4 of the largest gradient; all
tensors together within 0.66% in L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cd_parity as cdp
from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.ops.losses import create_loss as t_create_loss
from kurosiwo_torch.ops.metrics import MetricState as TMetricState
from kurosiwo_torch.training.state import create_train_state as t_create_state
from kurosiwo_torch.training.steps import make_train_step as t_train_step
from kurosiwo_tpu.ops import optim as j_optim
from kurosiwo_tpu.ops.losses import create_loss as j_create_loss
from kurosiwo_tpu.ops.metrics import MetricState as JMetricState
from kurosiwo_tpu.training import steps as j_steps
from kurosiwo_tpu.training.state import TrainState as JTrainState

torch.set_num_threads(4)

METHOD = "hfa-net"
LR = 1e-3
MCFG = {"optimizer": "sgd", "learning_rate": LR, "momentum": 0.9, "weight_decay": 1e-5}


def _cfg():
    return cdp.config(METHOD, batch=1, loss_function="cross_entropy",
                      class_weights=[1.0, 1.0, 1.0])


@pytest.fixture(scope="module")
def run():
    v = cdp.variables(METHOD)
    x1, x2 = cdp.frames(METHOD, batch=1)
    cfg = _cfg()
    model = cdp.j_init(cfg, MCFG)
    ev = cdp.jit_fast(lambda v, a, b: model.apply(v, a, b, train=False), v, x1, x2)
    out, upd = cdp.jit_fast(lambda v, a, b: model.apply(v, a, b, train=True,
                                                        mutable=["batch_stats"]), v, x1, x2)
    tx = j_optim.create_optimizer(cfg, MCFG, "cd")
    params = jax.tree.map(jnp.asarray, v["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                        opt_state=tx.init(params))
    rs = np.random.RandomState(5)
    batch = {"pre1": x1, "post": x2, "mask": rs.randint(0, 4, (1, 224, 224)).astype(np.int32)}
    step = j_steps.make_train_step(model, tx, j_create_loss(cfg, "train"), cfg, MCFG, "cd")
    new_state, _, loss = cdp.jit_fast(step, state, jax.tree.map(jnp.asarray, batch),
                                      JMetricState.create(), jnp.asarray(LR, jnp.float32),
                                      jax.random.PRNGKey(1))
    trace = new_state.opt_state.inner_state[1][0].trace  # chain(decay, sgd(trace, scale))
    return {"v": v, "x": (x1, x2), "eval": np.asarray(ev), "train": np.asarray(out),
            "batch_stats": cdp.tree(upd["batch_stats"]), "batch": batch, "loss": float(loss),
            "params": cdp.tree(new_state.params), "trace": cdp.tree(trace)}


def _model(run):
    model = cdp.t_init(_cfg(), MCFG, device="cpu")
    model.load_state_dict(flax_to_torch(run["v"]))
    return model


def test_state_dict_names_and_shapes_match_flax_tree():
    x = jnp.zeros((1, 224, 224, 2), jnp.float32)
    shapes = jax.eval_shape(lambda: cdp.jax_model(METHOD).init(jax.random.PRNGKey(0), x, x))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    want = {k: tuple(t.shape) for k, t in flax_to_torch(zeros).items()}
    got = {k: tuple(t.shape) for k, t in cdp.t_init(_cfg(), MCFG, device="cpu")
           .state_dict().items()}
    assert got == want
    assert "encoder.layer_1.hfab1.sa.ConvBNPReLU_10.PReLU_0.alpha" in got


def test_outputs_and_batch_stats_match_jax(run):
    model = _model(run)
    x = tuple(torch.from_numpy(a) for a in run["x"])
    with torch.no_grad():
        ev = model.eval()(*x)
        tr = model.train()(*x)
    np.testing.assert_allclose(ev.numpy(), run["eval"], atol=5e-4)
    np.testing.assert_allclose(tr.numpy(), run["train"], atol=5e-4)
    got = torch_to_flax(model.state_dict())["batch_stats"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(run["batch_stats"])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(run["batch_stats"])):
        np.testing.assert_allclose(g, w, atol=5e-4)


def test_flax_torch_round_trip_is_bit_exact(run):
    back = torch_to_flax(flax_to_torch(run["v"]))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(run["v"])):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_train_step_with_forced_sgd_matches_jax(run):
    cfg = dict(_cfg(), optimizer="adam")  # hfa-net takes SGD whatever the config names
    model = _model(run)
    state = t_create_state(model, cfg, dict(MCFG, optimizer="adam"), task="cd")
    assert isinstance(state.optimizer, torch.optim.SGD)
    step = t_train_step(model, t_create_loss(cfg, "train"), cfg, MCFG, task="cd", device="cpu")
    state, _, loss = step(state, run["batch"], TMetricState.create(), LR)
    np.testing.assert_allclose(float(loss), run["loss"], rtol=1e-4)
    buf = {n: state.optimizer.state[p]["momentum_buffer"] for n, p in model.named_parameters()}
    buf = torch_to_flax(buf)["params"]
    cdp.assert_gradients_close(buf, run["trace"], floor=1e-3)
    params = torch_to_flax(model.state_dict())["params"]
    top = max(np.abs(m).max() for m in jax.tree.leaves(run["trace"]))
    for g, w, m in zip(jax.tree.leaves(params), jax.tree.leaves(run["params"]),
                       jax.tree.leaves(run["trace"])):
        ulp = np.spacing(np.abs(w).max())  # the update's rounding
        assert np.abs(g - w).max() <= LR * max(5e-2 * np.abs(m).max(), 1e-3 * top) + ulp


def test_bf16_gradients_stay_at_the_f32_scale(run):
    """ROADMAP C18: the high-pass bank runs in f32 in a bf16 model; computed
    in bf16, its eight directions' gradient residue grew through the HFA
    blocks to 1e13 times the f32 model's gradients. The bf16 model's
    largest gradient stays within 10x of the f32 model's (measured: 1.0x to
    1.1x, layer by layer), and its first layer's gradient norm within 2x
    (measured: 1.29x)."""
    from kurosiwo_torch.ops.losses import create_loss

    top, first = {}, {}
    for mp in (False, True):
        cfg = dict(_cfg(), mixed_precision=mp)
        model = cdp.t_init(cfg, MCFG, device="cpu")
        model.load_state_dict(flax_to_torch(run["v"]))
        x = tuple(torch.from_numpy(a) for a in run["x"])
        mask = torch.from_numpy(run["batch"]["mask"])
        create_loss(cfg, "train")(model.train()(*x), mask).backward()
        top[mp] = max(p.grad.abs().max().item() for p in model.parameters())
        first[mp] = model.encoder.pre_treat.weight.grad.norm().item()
    print(f"port first-layer gradient norm: f32 {first[False]:.6e}, bf16 {first[True]:.6e}")
    assert top[True] <= 10 * top[False]
    assert 0.5 * first[False] <= first[True] <= 2 * first[False]


def test_jax_bf16_high_pass_bank_is_the_fault_the_port_departs_from(run):
    """ROADMAP C18's other half: the JAX package's HFA-Net, which computes
    the bank in the compute dtype, takes in bf16 a first-layer gradient
    more than 1e6 times its f32 gradient on the same weights and batch
    (measured: 9.8e12 times), so
    the port's f32 bank departs from a reference that is broken in bf16,
    not from a sound one. Should this fail, the JAX package's bf16 HFA-Net
    has been repaired, and the port's bank should follow it."""
    x1, x2 = (jnp.asarray(a) for a in run["x"])
    mask = jnp.asarray(run["batch"]["mask"])
    params = jax.tree.map(jnp.asarray, run["v"]["params"])

    def grads_of(cfg):
        model, loss_fn = cdp.j_init(cfg, MCFG), j_create_loss(cfg, "train")

        def loss(p):
            out, _ = model.apply({"params": p, "batch_stats": run["v"]["batch_stats"]}, x1, x2,
                                 train=True, mutable=["batch_stats"])
            return loss_fn(out.astype(jnp.float32), mask)

        return np.asarray(cdp.jit_fast(jax.grad(loss), params)["encoder"]["pre_treat"]["kernel"])

    norms = {mp: float(np.linalg.norm(grads_of(dict(_cfg(), mixed_precision=mp))))
             for mp in (False, True)}
    print(f"JAX first-layer gradient norm: f32 {norms[False]:.6e}, bf16 {norms[True]:.6e}")
    assert norms[True] > 1e6 * norms[False]
