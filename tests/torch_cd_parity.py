"""What the port's change-detection parity tests share: the models' tiny
configs, seeded weights (the port's init, with perturbed BatchNorm and
LayerNorm affine and BatchNorm statistics) as both a torch ``state_dict``
and flax variables, the Dropout2d masks JAX draws, recorded and fed to the
port (the port cannot replay ``make_rng("dropout")``'s stream; ROADMAP
C16), and for the attention models (BiT-CD, ChangeFormer, TransUNet-CD)
one jitted JAX run of the model and its steps, with ChangeFormer's DropPath
masks drawn from a seeded numpy stream on the JAX side and fed to the port
(ROADMAP C19)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import torch_to_flax
from kurosiwo_torch.models.factory import initialize_cd_model as t_init
from kurosiwo_torch.ops import nn as tnn
from kurosiwo_tpu.models import changeformer as jcf
from kurosiwo_tpu.models.factory import initialize_cd_model as j_init
from kurosiwo_tpu.ops import nn as jnn

# method -> the square input side its tiny parity runs use: SNUNet and ADHR
# need multiples of 16 and 8; 36 makes Siam's replication pad act (36 -> 18
# -> 9 -> 4 -> 2, upsampled to 4, 8, 18, 36); HFA-Net fits 224 only; the
# attention models run at 32 (BiT's map 8x8, ChangeFormer's stages 8, 4, 2
# and 1, TransUNet's ViT grid 2x2)
SIZES = {"snunet": 32, "siam-diff": 36, "siam-conc": 36, "adhr-cdnet": 32, "hfa-net": 224,
         "bit-cd": 32, "changeformer": 32, "transunet-cd": 32}
MCFG = {"base_channel": 8}  # SNUNet's width, cut from 32; the other models have no width key
# XLA's CPU compiler at its lowest optimization level: the attention models'
# jitted steps compile in about half the time, to the same function
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def config(method: str, batch: int = 2, **kw) -> dict:
    return {"task": "cd", "method": method, "num_classes": 3, "num_channels": 2,
            "mixed_precision": False, "batch_size": batch, "remat": False,
            "inputs": ["pre_event_1", "post_event"], "dem": False,
            "synthetic_patch_size": SIZES[method], **kw}


def frames(method: str, batch: int = 2, seed: int = 0):
    rs = np.random.RandomState(seed)
    s = SIZES[method]
    return (rs.randn(batch, s, s, 2).astype(np.float32),
            rs.randn(batch, s, s, 2).astype(np.float32))


def variables(method: str, seed: int = 0, mcfg: dict = MCFG) -> dict:
    """Flax variables from the port's seeded init, the norms' scale and
    bias and BatchNorm's mean and var perturbed so that the eval path is not
    an identity."""
    model = t_init(config(method), mcfg, device="cpu", seed=seed)
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

    walk(v["params"], False)
    walk(v["batch_stats"], True)
    return v


def jax_model(method: str, mcfg: dict = MCFG, **kw):
    return j_init(config(method, **kw), mcfg)


@contextlib.contextmanager
def recorded_jax_masks():
    """JAX's Dropout2d with each mask it draws appended to the yielded list
    (run the JAX apply eagerly so that the masks are concrete)."""
    masks = []

    def recording(self, x, deterministic=True):
        if deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep,
                                    shape=(x.shape[0], 1, 1, x.shape[-1]))
        masks.append(np.asarray(mask))
        return jnp.where(mask, x / keep, 0.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn.Dropout2d, "__call__", recording)
        yield masks


@contextlib.contextmanager
def fed_masks(masks, layer=tnn.Dropout2d):
    """The port's ``layer`` (Dropout2d, DropPath) draws ``masks`` in order;
    all of them must be used."""
    it = iter(list(masks))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layer, "draw_mask", lambda self, x, g: torch.from_numpy(np.array(next(it))))
        yield
    assert next(it, None) is None, "the port drew fewer masks than JAX"


@contextlib.contextmanager
def seeded_jax_drop_path(seed: int = 0):
    """JAX's ChangeFormer DropPath with its keep-masks drawn from a seeded
    numpy stream, in call order, while the function traces (so they are
    constants of a jitted run), each appended to the yielded list; the
    layer's arithmetic is JAX's own. (jax.random's threefry doubles the
    compile time of a jitted step on the CPU.)"""
    masks, rs = [], np.random.RandomState(seed)

    def seeded(self, x, deterministic=True):
        if deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = rs.rand(x.shape[0], *(1,) * (x.ndim - 1)) < keep
        masks.append(mask)
        return jnp.where(jnp.asarray(mask), x / keep, 0.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcf.DropPath, "__call__", seeded)
        yield masks


def jit_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with ``FAST_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


class FastInit:
    """A flax model whose ``init`` is one call compiled with FAST_COMPILE
    (``jit_fast``), in place of an op-by-op dispatch that compiles each op."""

    def __init__(self, model):
        self.model = model

    def init(self, rngs, *inputs, **kw):
        return jit_fast(lambda r, *xs: self.model.init(r, *xs, **kw), rngs, *inputs)


class FastJax:
    """The ``jax`` a JAX training module sees (kurosiwo_tpu.training.mae,
    .diffusion), monkeypatched in: its ``jit`` compiles with FAST_COMPILE
    at the first call, as ``jit_fast`` does."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        jitted, compiled = jax.jit(fn, **kw), []

        def call(*args):
            if not compiled:
                compiled.append(jitted.lower(*args).compile(compiler_options=FAST_COMPILE))
            return compiled[0](*args)

        return call


def tree(x):
    return jax.tree.map(np.asarray, dict(x))


def assert_gradients_close(got, want, rel: float = 5e-2, floor: float = 1e-6):
    """torch_step_parity.assert_first_moment_close's bands (each tensor
    within ``rel``, 5%, of its largest value, all within 2% in L2), with a
    floor for
    the tensors whose gradient is zero in exact arithmetic: a conv bias that
    feeds a train-mode BatchNorm alone (SNUNet's conv2, for one) has a
    gradient of rounding noise in both frameworks (1e-13 to 1e-8 here,
    against 5e-2 for the largest gradient), which no relative band can hold.
    Such a tensor is held within ``floor`` (1e-6) of the tree's largest
    gradient."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    leaves = list(zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    floor = floor * max(np.abs(w).max() for _, w in leaves)
    num = den = 0.0
    for g, w in leaves:
        assert np.abs(g - w).max() <= max(rel * np.abs(w).max(), floor)
        num += float(np.square(g - w).sum())
        den += float(np.square(w).sum())
    assert np.sqrt(num / den) <= 2e-2


# the attention models' step runs: RandomEvents class weights, lr 1e-3
CW = [0.3715753140309927, 14.009780283125977, 8.20405370357821]
LR = 1e-3


def method_config(method: str, **overrides) -> dict:
    """The shipped configs/method file at lr 1e-3, with ``overrides`` (the
    tests' widths)."""
    import pathlib

    from kurosiwo_torch.config import load_json5

    root = pathlib.Path(__file__).resolve().parent.parent / "configs" / "method" / method
    return {**load_json5(root / (method.replace("-", "_") + ".json")), "learning_rate": LR,
            **overrides}


def step_config(method: str) -> dict:
    return config(method, class_weights=CW, weighted=True, loss_function="cross_entropy",
                  fused_tail=False, log_zone_metrics=False)


def step_batch(method: str, seed: int, sample_weight=None) -> dict:
    rs = np.random.RandomState(seed)
    s = SIZES[method]
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


def attention_run(method: str, mcfg: dict, steps: bool = True, infer: bool = False,
                  v: dict | None = None) -> dict:
    """One jitted JAX run from ``v`` (default ``variables(method,
    mcfg=mcfg)``): the eval
    and train outputs of the model on ``frames(method)`` (with the updated
    batch statistics); with ``steps`` one train step (``step_batch(method,
    0)``, the method's optimizer at ``LR``) and the eval step of its result
    (``step_batch(method, 1)``, the second sample weighted 0); with
    ``infer`` also that eval step with ``multi_scale_infer``. ChangeFormer's
    DropPath masks come from ``seeded_jax_drop_path`` and are returned in
    call order, those of the train output and those of the step. (The
    jitted step costs most of a run: about 12 s of tracing and compiling for
    BiT with eight decoder layers.)"""
    from kurosiwo_tpu.ops import optim as j_optim
    from kurosiwo_tpu.ops.losses import create_loss
    from kurosiwo_tpu.ops.metrics import MetricState
    from kurosiwo_tpu.training import steps as j_steps
    from kurosiwo_tpu.training.state import TrainState

    cfg = step_config(method)
    v = jax.tree.map(jnp.asarray, variables(method, mcfg=mcfg) if v is None else v)
    model = j_init(cfg, mcfg)
    tx = j_optim.create_optimizer(cfg, mcfg, "cd")
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    step = j_steps.make_train_step(model, tx, create_loss(cfg, "train"), cfg, mcfg, "cd")
    evals = {"eval": j_steps.make_eval_step(model, create_loss(cfg, "val"), cfg, mcfg, "cd")}
    if infer:
        evals["infer"] = j_steps.make_eval_step(model, create_loss(cfg, "val"), cfg,
                                                dict(mcfg, multi_scale_infer=True), "cd")
    x1, x2 = frames(method)
    tb, eb = step_batch(method, 0), step_batch(method, 1, sample_weight=[1.0, 0.0])
    key = jax.random.PRNGKey(1)
    split = {}

    def run(v, state, tb, eb, x1, x2):
        out = {"eval": model.apply(v, x1, x2, train=False)}
        split["train"] = len(masks)
        out["train"], upd = model.apply(v, x1, x2, train=True, mutable=["batch_stats"],
                                        rngs={"dropout": key})
        out["train_stats"] = upd["batch_stats"]
        split["step"] = len(masks)
        if not steps:
            split["end"] = len(masks)
            return out
        new, ms, loss = step(state, tb, MetricState.create(), jnp.asarray(LR, jnp.float32), key)
        split["end"] = len(masks)
        out.update(loss=loss, cm=ms.cm, params=new.params, batch_stats=new.batch_stats,
                   moment=_find(new.opt_state, "trace" if mcfg["optimizer"] == "sgd" else "mu"))
        for name, ev in evals.items():
            ems, eloss, _ = ev(new, eb, MetricState.create())
            out[name + "_loss"], out[name + "_cm"] = eloss, ems.cm
        return out

    with seeded_jax_drop_path() as masks:
        res = jit_fast(run, v, state, jax.tree.map(jnp.asarray, tb),
                       jax.tree.map(jnp.asarray, eb), jnp.asarray(x1), jnp.asarray(x2))
    res = jax.tree.map(np.asarray, res)
    res = {k: tree(r) if isinstance(r, dict) else r for k, r in res.items()}
    return {"method": method, "cfg": cfg, "mcfg": mcfg, "v": jax.tree.map(np.asarray, v),
            "x": (x1, x2), "batch": tb, "eval_batch": eb, "sgd": mcfg["optimizer"] == "sgd",
            "train_masks": masks[split["train"]:split["step"]],
            "step_masks": masks[split["step"]:split["end"]], **res}


def port_model(run: dict, variables: dict | None = None):
    """The port's model of ``run`` on the CPU with ``variables`` (default:
    the run's initial ones) loaded."""
    from kurosiwo_torch.convert import flax_to_torch

    model = t_init(run["cfg"], run["mcfg"], device="cpu")
    model.load_state_dict(flax_to_torch(run["v"] if variables is None else variables))
    return model


def assert_cm_close(got, want, mask):
    """Row sums equal, each cell within 0.1% of the valid pixels."""
    valid = int((np.asarray(mask) != 3).sum())
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert np.abs(got - want).max() <= 1e-3 * valid


def check_train_step(run: dict, layer=tnn.DropPath) -> None:
    """The port's train step from the run's weights and batch against JAX's
    (tests/test_torch_cd_steps.py's bands): loss rtol 1e-4; the cm; SGD's
    momentum buffer within 8% of each tensor's largest value (2% in L2) and
    its parameters within lr times that, Adam's first moment within 5% and
    its parameters as ``assert_adam_step_close``; batch statistics atol
    1e-4."""
    from kurosiwo_torch.convert import torch_to_flax
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.state import create_train_state
    from kurosiwo_torch.training.steps import make_train_step
    from torch_step_parity import assert_adam_step_close

    model = port_model(run)
    state = create_train_state(model, run["cfg"], run["mcfg"], task="cd")
    step = make_train_step(model, create_loss(run["cfg"], "train"), run["cfg"], run["mcfg"],
                           task="cd", device="cpu")
    with fed_masks(run["step_masks"], layer):
        state, ms, loss = step(state, run["batch"], MetricState.create(), LR)
    np.testing.assert_allclose(float(loss), float(run["loss"]), rtol=1e-4)
    assert_cm_close(ms.cm.numpy(), run["cm"], run["batch"]["mask"])
    tree_ = torch_to_flax(model.state_dict())
    key = "momentum_buffer" if run["sgd"] else "exp_avg"
    moment = torch_to_flax({name: state.optimizer.state[p][key]
                            for name, p in model.named_parameters()})["params"]
    assert_gradients_close(moment, run["moment"], rel=8e-2 if run["sgd"] else 5e-2)
    if run["sgd"]:  # p - lr * buffer: the buffer's band (and floor) times lr
        top = max(np.abs(m).max() for m in jax.tree.leaves(run["moment"]))
        for g, w, m in zip(jax.tree.leaves(tree_["params"]), jax.tree.leaves(run["params"]),
                           jax.tree.leaves(run["moment"])):
            ulp = np.spacing(np.abs(w).max())
            assert np.abs(g - w).max() <= LR * max(8e-2 * np.abs(m).max(), 1e-6 * top) + ulp
    else:
        assert_adam_step_close(tree_["params"], run["params"], LR)
    for g, w in zip(jax.tree.leaves(tree_["batch_stats"]), jax.tree.leaves(run["batch_stats"])):
        np.testing.assert_allclose(g, w, atol=1e-4)


def check_eval_step(run: dict, name: str = "eval", **mcfg) -> None:
    """The port's eval step (model config ``run["mcfg"]`` updated by
    ``mcfg``) from JAX's trained weights against JAX's: loss rtol 1e-4, the
    cm of the sample of weight 1."""
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.steps import make_eval_step

    model = port_model(run, {"params": run["params"], "batch_stats": run["batch_stats"]})
    ev = make_eval_step(model, create_loss(run["cfg"], "val"), run["cfg"],
                        dict(run["mcfg"], **mcfg), task="cd", device="cpu")
    ms, loss, _ = ev(None, run["eval_batch"], MetricState.create())
    np.testing.assert_allclose(float(loss), float(run[name + "_loss"]), rtol=1e-4)
    eb = run["eval_batch"]
    assert_cm_close(ms.cm.numpy(), run[name + "_cm"],
                    np.where(eb["sample_weight"][:, None, None] > 0, eb["mask"], 3))
    assert float(ms.count) == 1.0


def check_outputs(run: dict, layer=tnn.DropPath) -> None:
    """Eval and train outputs (each head of a list) and the train forward's
    batch statistics against JAX's, atol 5e-4."""
    from kurosiwo_torch.convert import torch_to_flax

    x = tuple(torch.from_numpy(a) for a in run["x"])
    model = port_model(run).eval()
    with torch.no_grad():
        ev = model(*x)
        model.train()
        with fed_masks(run["train_masks"], layer):
            tr = model(*x)
    for got, want in ((ev, run["eval"]), (tr, run["train"])):
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, atol=5e-4)
    got = torch_to_flax(model.state_dict())["batch_stats"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(run["train_stats"])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(run["train_stats"])):
        np.testing.assert_allclose(g, w, atol=5e-4)


def check_names_and_round_trip(run: dict) -> None:
    """The port's state_dict names and shapes are the flax tree's (JAX's
    init, by shape only), and the bridge's round trip is bit-exact."""
    from kurosiwo_torch.convert import flax_to_torch, torch_to_flax

    x1, x2 = (jnp.zeros(a.shape, jnp.float32) for a in run["x"])
    shapes = jax.eval_shape(lambda: j_init(run["cfg"], run["mcfg"]).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x1, x2))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    want = {k: tuple(t.shape) for k, t in flax_to_torch(zeros).items()}
    got = {k: tuple(t.shape) for k, t in port_model(run).state_dict().items()}
    assert got == want
    back = torch_to_flax(flax_to_torch(run["v"]))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(run["v"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(run["v"])):
        assert a.dtype == b.dtype and np.array_equal(a, b)
