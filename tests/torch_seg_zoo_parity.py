"""What the segmentation-zoo parity tests share (UNet++, DeepLabV3+,
UperNet on ConvNeXt and Swin, the FloodViT finetuner): seeded weights from
the port's init with the norms' affine, BatchNorm's statistics and
ConvNeXt's layer scale perturbed, carried to flax through
kurosiwo_torch.convert; one jitted JAX run of a model (compiled at XLA's
lowest optimization level, ``torch_cd_parity.jit_fast``): its eval logits,
its train-mode logits with the updated batch statistics, one train step
(Adam, RandomEvents-weighted cross entropy, lr 1e-3) and the eval step of
the result; and the checks that hold the port's model and steps to it.

Bands (ROADMAP C5, C6): logits and batch statistics atol 5e-4 across
frameworks in f32 (UperNet 1e-3); the step's loss rtol 1e-4, the
confusion matrix within 0.1% of the valid pixels, Adam's parameters as
``assert_adam_step_close``, its first moment within 5% of each tensor's L2
norm and 2% over the tree (``check_train_step``), the step's batch
statistics atol 1e-4; the bridge bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_cd_parity as cdp
from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from torch_step_parity import assert_adam_step_close

CW = cdp.CW
LR = 1e-3


def config(method: str, side: int, n: int = 2, **kw) -> dict:
    return {"task": "segmentation", "method": method, "num_classes": 3, "num_channels": 6,
            "inputs": ["pre_event_1", "pre_event_2", "post_event"], "channels": ["vv", "vh"],
            "class_weights": CW, "weighted": True, "loss_function": "cross_entropy",
            "batch_size": n, "optimizer": "adam", "learning_rate": LR,
            "mixed_precision": False, "dem": False, "fused_tail": False,
            "log_zone_metrics": False, "synthetic_patch_size": side, **kw}


def batch(side: int, seed: int, sample_weight=None, n: int = 2) -> dict:
    rs = np.random.RandomState(seed)
    b = {k: rs.randn(n, side, side, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["mask"] = rs.randint(0, 4, (n, side, side)).astype(np.int32)
    if sample_weight is not None:
        b["sample_weight"] = np.asarray(sample_weight, np.float32)
    return b


def image(b: dict) -> np.ndarray:
    """The segmentation input the steps assemble: post, pre1, pre2."""
    return np.concatenate([b["post"], b["pre1"], b["pre2"]], axis=-1)


def variables(model: torch.nn.Module, seed: int = 0) -> dict:
    """Flax variables of the port's init, perturbed: norm scales 1 + 0.2 N,
    biases 0.1 N, BatchNorm means 0.1 N and variances 1 + 0.5 U, ConvNeXt's
    layer scale ``gamma`` 0.3 + 0.1 N (its init, 1e-6, would mute every
    block)."""
    v = torch_to_flax(model.state_dict())
    rs = np.random.RandomState(seed + 100)

    def walk(node, stats):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, stats)
            elif name == "scale" or (stats and name == "var"):
                node[name] = (1.0 + (0.2 * rs.randn(*leaf.shape) if name == "scale"
                                     else 0.5 * rs.rand(*leaf.shape))).astype(np.float32)
            elif (name == "bias" and "scale" in node) or (stats and name == "mean"):
                node[name] = (0.1 * rs.randn(*leaf.shape)).astype(np.float32)
            elif name == "gamma":
                node[name] = (0.3 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)

    walk(v["params"], False)
    walk(v["batch_stats"], True)
    return v


def jax_run(jmodel, tmodel: torch.nn.Module, cfg: dict, side: int,
            mcfg: dict | None = None) -> dict:
    """One jitted JAX run of ``jmodel`` from the perturbed weights of
    ``tmodel``: eval and train-mode logits on ``image(batch(side, 2))`` with
    the updated batch statistics, one train step on ``batch(side, 0)`` and
    the eval step of its result on ``batch(side, 1)`` (all but its first
    sample weighted 0); each batch of ``cfg["batch_size"]``."""
    from kurosiwo_tpu.ops import optim as j_optim
    from kurosiwo_tpu.ops.losses import create_loss
    from kurosiwo_tpu.ops.metrics import MetricState
    from kurosiwo_tpu.training import steps as j_steps
    from kurosiwo_tpu.training.state import TrainState

    mcfg = dict(mcfg or {}, learning_rate=LR)
    v = variables(tmodel)
    n = cfg["batch_size"]
    tb = batch(side, 0, n=n)
    eb = batch(side, 1, sample_weight=[1.0] + [0.0] * (n - 1), n=n)
    x = image(batch(side, 2, n=n))
    jv = jax.tree.map(jnp.asarray, v)

    def run(v, x, tb, eb):
        out = {"eval": jmodel.apply(v, x, train=False)}
        out["train"], upd = jmodel.apply(v, x, train=True, mutable=["batch_stats"])
        out["train_stats"] = upd["batch_stats"]
        tx = j_optim.create_optimizer(cfg, mcfg, "segmentation")
        state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
        step = j_steps.make_train_step(jmodel, tx, create_loss(cfg, "train"), cfg, mcfg,
                                       "segmentation")
        new, ms, loss = step(state, tb, MetricState.create(), jnp.asarray(LR, jnp.float32),
                             jax.random.PRNGKey(1))
        ev = j_steps.make_eval_step(jmodel, create_loss(cfg, "val"), cfg, mcfg, "segmentation")
        ems, eloss, _ = ev(new, eb, MetricState.create())
        out.update(loss=loss, cm=ms.cm, params=new.params, batch_stats=new.batch_stats,
                   mu=cdp._find(new.opt_state, "mu"), eval_loss=eloss, eval_cm=ems.cm)
        return out

    res = cdp.jit_fast(run, jv, jnp.asarray(x), jax.tree.map(jnp.asarray, tb),
                       jax.tree.map(jnp.asarray, eb))
    res = jax.tree.map(np.asarray, res)
    res = {k: cdp.tree(r) if isinstance(r, dict) else r for k, r in res.items()}
    return {"v": v, "x": x, "batch": tb, "eval_batch": eb, "cfg": cfg, "mcfg": mcfg, **res}


def load(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    model.load_state_dict(flax_to_torch(variables))
    return model


def check_names_and_round_trip(jmodel, tmodel: torch.nn.Module, run: dict) -> None:
    """The port's state_dict names and shapes are the flax tree's (JAX's
    init, by shape only), and the bridge's round trip is bit-exact."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros(run["x"].shape, jnp.float32)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    want = {k: tuple(t.shape) for k, t in flax_to_torch(zeros).items()}
    assert {k: tuple(t.shape) for k, t in tmodel.state_dict().items()} == want
    back = torch_to_flax(flax_to_torch(run["v"]))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(run["v"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(run["v"])):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def check_outputs(tmodel: torch.nn.Module, run: dict, atol: float = 5e-4,
                  eval_logits=None) -> None:
    """Eval logits (``eval_logits``, default the run's) and train-mode
    logits, both f32, and the train forward's batch statistics, against
    JAX's."""
    model = load(tmodel, run["v"]).eval()
    x = torch.from_numpy(run["x"])
    with torch.no_grad():
        ev = model(x)
        model.train()
        tr = model(x)
    for got, want in ((ev, run["eval"] if eval_logits is None else eval_logits),
                      (tr, run["train"])):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=atol)
    got = torch_to_flax(model.state_dict())["batch_stats"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(run["train_stats"])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(run["train_stats"])):
        np.testing.assert_allclose(g, w, atol=5e-4)


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def check_train_step(make, run: dict) -> None:
    """The port's step against JAX's at the bands of the module docstring.
    Adam's first moment (the gradient) is held within 5% of each tensor's
    L2 norm and 2% over the tree; a tensor whose gradient is zero in exact
    arithmetic (a norm's bias before a conv and a train-mode BatchNorm:
    UperNet's ``out_norm{s}`` biases, 1e-10 here) within 1e-6 of the tree's
    largest gradient, as ``torch_cd_parity.assert_gradients_close`` holds
    it. (C6's other clause, each element within
    5% of its tensor's largest, fails on one ReLU input on the other side
    of zero after a train-mode BatchNorm: on these small maps that moves a
    conv's gradient by up to 11% of its largest element, and the port's
    own step moves DeepLabV3+'s decoder gradients by 3-5% of theirs under a
    1e-6 change of the images; the same tensors stay within 1.8% in L2.)"""
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.state import create_train_state
    from kurosiwo_torch.training.steps import make_train_step

    model = load(make(), run["v"])
    state = create_train_state(model, run["cfg"], run["mcfg"])
    step = make_train_step(model, create_loss(run["cfg"], "train"), run["cfg"], run["mcfg"],
                           device="cpu")
    state, ms, loss = step(state, run["batch"], MetricState.create(), LR)
    np.testing.assert_allclose(float(loss), float(run["loss"]), rtol=1e-4)
    cdp.assert_cm_close(ms.cm.numpy(), run["cm"], run["batch"]["mask"])
    tree = torch_to_flax(model.state_dict())
    mu = torch_to_flax({name: state.optimizer.state[p]["exp_avg"]
                        for name, p in model.named_parameters()})["params"]
    assert jax.tree_util.tree_structure(mu) == jax.tree_util.tree_structure(run["mu"])
    floor = 1e-6 * max(np.abs(w).max() for w in jax.tree.leaves(run["mu"]))
    num = den = 0.0
    for g, w in zip(jax.tree.leaves(mu), jax.tree.leaves(run["mu"])):
        assert rel_l2(g, w) <= 5e-2 or np.abs(g - w).max() <= floor
        num += float(np.square(g - w).sum())
        den += float(np.square(w).sum())
    assert np.sqrt(num / den) <= 2e-2
    assert_adam_step_close(tree["params"], run["params"], LR)
    for g, w in zip(jax.tree.leaves(tree["batch_stats"]), jax.tree.leaves(run["batch_stats"])):
        np.testing.assert_allclose(g, w, atol=1e-4)


def check_eval_step(tmodel: torch.nn.Module, run: dict) -> None:
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.steps import make_eval_step

    model = load(tmodel, {"params": run["params"], "batch_stats": run["batch_stats"]})
    ev = make_eval_step(model, create_loss(run["cfg"], "val"), run["cfg"], run["mcfg"],
                        device="cpu")
    ms, loss, _ = ev(None, run["eval_batch"], MetricState.create())
    np.testing.assert_allclose(float(loss), float(run["eval_loss"]), rtol=1e-4)
    eb = run["eval_batch"]
    cdp.assert_cm_close(ms.cm.numpy(), run["eval_cm"],
                        np.where(eb["sample_weight"][:, None, None] > 0, eb["mask"], 3))
    assert float(ms.count) == 1.0
