"""The rest of the port's MAE pretraining against the JAX package's, on the
CPU at a tiny size: ``lr_scales`` (parameter groups, against optax's
``lr_scale_by_path``), the SSL loader (``data/ssl.py``) and the epoch loop
``training/mae.train`` (image 64, patch 16, dim 64, depth 1, decoder 32 x 1,
batch 8 at accum 2, 2 epochs of 2 steps; tests/test_train_e2e.py's sizes;
the batch divides the 8 CPU devices of the JAX package's mesh).

Exactness classes (ROADMAP C5):
- bit-exact: which parameters each ``lr_scales`` pattern selects; the SSL
  batches (synthetic, and a corpus written here with cv2: the walk, its
  cache, the shuffle, the crops, the flips, over two epochs); the per-step
  learning rate of the loop; the names of the checkpoints it writes; an
  ``AdamBF16Moments`` checkpoint round trip with several groups;
- cross-framework banded (C6): three Adam steps with and without the
  scales under a changing lr, every parameter within 1e-2 of the summed
  scaled lr with bf16 moments (a moment can round to the other side of a
  bf16 boundary) and 1e-5 of it with f32 moments; the loop's losses rtol
  1e-4 while the parameters are JAX's (lr 0 in the first step), 2e-3
  after; its final parameters all within twice the summed lr and 99%
  within 0.3 of it (Adam's sign flips at near-zero gradients, C6), with
  JAX's masking noise fed to the port (C7).

JAX's model init, train step and optax update are compiled with
torch_cd_parity's FAST_COMPILE, as ``jit_fast`` compiles the other tests'.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.data import ssl as t_ssl
from kurosiwo_torch.models.factory import build_mae as t_build_mae
from kurosiwo_torch.ops import optim as t_optim
from kurosiwo_torch.training import mae as t_mae
from kurosiwo_torch.training.checkpoint import CheckpointManager as TCheckpoints
from kurosiwo_tpu.data import ssl as j_ssl
from kurosiwo_tpu.ops import optim as j_optim
from kurosiwo_tpu.training import mae as j_mae
from torch_cd_parity import FAST_COMPILE, FastInit, FastJax, jit_fast

torch.set_num_threads(2)

MCFG = {"image_size": 64, "patch_size": 16, "dim": 64, "depth": 1, "heads": 2,
        "mlp_dim": 64, "decoder_dim": 32, "decoder_depth": 1, "decoder_heads": 2,
        "masked_ratio": 0.75, "accumulate_gradients": 2, "warmup_epochs": 1,
        "learning_rate": 1e-4, "min_lr": 0}
N = (64 // 16) ** 2
SCALES = {"attn_0/to_qkv/kernel": 0.5, "encoder/": 0.25, "decoder/": 2.0, "bias": 3.0}


def _tiny_mae(seed=0):
    return t_build_mae({"num_channels": 6, "mixed_precision": False}, MCFG, device="cpu",
                       seed=seed)


# ---------------------------------------------------------------- lr_scales

def test_lr_scale_groups_select_the_jax_parameters():
    """Each parameter's scale is the one JAX's lr_scale_by_path gives its
    flax path (first pattern wins; ``kernel`` is the port's ``weight``)."""
    model = _tiny_mae()
    params = torch_to_flax(model.state_dict())["params"]
    ones = jax.tree.map(lambda a: jnp.ones(a.shape), params)
    tx = j_optim.lr_scale_by_path(SCALES)
    want, _ = tx.update(ones, tx.init(ones))
    groups = t_optim.lr_scale_groups(model.named_parameters(), SCALES)
    assert [g["lr_scale"] for g in groups] == [1.0, 0.25, 0.5, 3.0, 2.0]
    scale_of = {id(p): g["lr_scale"] for g in groups for p in g["params"]}
    got = torch_to_flax({n: torch.full_like(p, scale_of[id(p)])
                         for n, p in model.named_parameters()})["params"]
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert t_optim.flax_path("encoder.transformer.attn_0.to_qkv.weight") == \
        "encoder/transformer/attn_0/to_qkv/kernel"


@pytest.mark.parametrize("scales", [None, SCALES], ids=["plain", "lr_scales"])
@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_adam_steps_match_optax(moments, scales):
    """Three steps of the MAE optimizer (optax's create_optimizer for
    "mae") on the same gradients, the lr changed each step as the schedule
    changes it, the port's groups against optax's chain."""
    model = _tiny_mae()
    named = list(model.named_parameters())
    cfg = {"optimizer_moment_dtype": moments, **({"lr_scales": scales} if scales else {})}
    lrs = [1e-3, 5e-4, 2e-3]
    tx = j_optim.create_optimizer(cfg, {"learning_rate": lrs[0]}, task="mae")
    # copies: jnp.asarray of a CPU array aliases its memory, and torch_to_flax
    # hands out views of the parameters wherever no transpose is needed (the
    # biases, norms, mask_token): opt.step() would then write into JAX's
    # first-step parameters, racing the asynchronously dispatched update
    jp = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                      torch_to_flax(model.state_dict())["params"])
    state = tx.init(jp)
    opt = t_optim.create_optimizer(named, cfg, {"learning_rate": lrs[0]}, task="mae")
    assert len(opt.param_groups) == (5 if scales else 1)
    rs = np.random.RandomState(3)
    gdt = jnp.bfloat16 if moments == "bfloat16" else jnp.float32
    update = None  # optax's update with the lr injected, compiled once (FAST_COMPILE)
    for lr in lrs:
        grads = {n: rs.randn(*p.shape).astype(np.float32) for n, p in named}
        jg = jax.tree.map(lambda a: jnp.asarray(a, gdt), torch_to_flax(
            {n: torch.from_numpy(g) for n, g in grads.items()})["params"])
        lr_j = jnp.asarray(lr, jnp.float32)
        if update is None:
            update = jax.jit(lambda g, s, p, r: tx.update(g, j_optim.inject_lr(s, r), p)).lower(
                jg, state, jp, lr_j).compile(compiler_options=FAST_COMPILE)
        upd, state = update(jg, state, jp, lr_j)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for n, p in named:
            p.grad = torch.from_numpy(grads[n])
        t_optim.set_learning_rate(opt, lr)
        opt.step()
    band = (1e-2 if moments == "bfloat16" else 1e-5) * sum(lrs) * 3.0
    got = torch_to_flax(model.state_dict())["params"]
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        w = np.asarray(w)  # and the f32 rounding of p + u, twice
        np.testing.assert_allclose(g, w, atol=band + 2 * np.spacing(np.abs(w).max()), rtol=0)


def test_lr_scale_groups_mae():
    """tests/test_schedules_optim.py::test_lr_scale_groups_mae on the port:
    params under "encoder/" take lr * 0.25, the others lr; a new lr reaches
    every group through set_learning_rate."""
    def fresh():
        m = torch.nn.Module()
        m.encoder, m.head = torch.nn.Module(), torch.nn.Module()
        m.encoder.w = torch.nn.Parameter(torch.ones(4))
        m.head.w = torch.nn.Parameter(torch.ones(4))
        return m

    for lr in (1e-3, 2e-3):
        m = fresh()
        opt = t_optim.create_optimizer(m.named_parameters(), {"method": "mae"},
                                       {"learning_rate": 1e-3, "lr_scales": {"encoder/": 0.25}},
                                       task="mae")
        t_optim.set_learning_rate(opt, lr)
        for p in m.parameters():
            p.grad = torch.full_like(p, 2.0)
        opt.step()
        # Adam's first update is lr in magnitude; the encoder's is scaled
        np.testing.assert_allclose((m.head.w - 1).detach().numpy(), -lr, rtol=1e-2)
        np.testing.assert_allclose((m.encoder.w - 1).detach().numpy(), -0.25 * lr, rtol=1e-2)


def test_adam_bf16_moments_round_trip_is_bitwise_with_groups(tmp_path):
    model = _tiny_mae()
    cfg = {"lr_scales": SCALES}
    opt = t_optim.create_optimizer(model.named_parameters(), cfg, {"learning_rate": 1e-3}, "mae")
    rs = np.random.RandomState(5)

    def step(m, o):
        for p in m.parameters():
            p.grad = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
        t_optim.set_learning_rate(o, 1e-3)
        o.step()

    step(model, opt)
    torch.save({"opt": opt.state_dict(), "model": model.state_dict()}, tmp_path / "ck")
    saved = torch.load(tmp_path / "ck", weights_only=True)
    twin = _tiny_mae(seed=9)
    twin.load_state_dict(saved["model"])
    opt2 = t_optim.create_optimizer(twin.named_parameters(), cfg, {"learning_rate": 1e-3}, "mae")
    opt2.load_state_dict(saved["opt"])
    assert [g["lr_scale"] for g in opt2.param_groups] == [g["lr_scale"] for g in opt.param_groups]
    for (m, v), (m2, v2) in zip(opt._flat, opt2._flat):
        assert torch.equal(m, m2) and torch.equal(v, v2) and m2.dtype == torch.bfloat16
    state = rs.get_state()
    step(model, opt)
    rs.set_state(state)
    step(twin, opt2)
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- SSL loader

SSL_CFG = {"batch_size": 4, "num_workers": 2, "image_size": 32, "synthetic_patch_size": 48,
           "channels": ["vv", "vh"], "clamp_input": 0.15}


def _epochs(loader, n=2):
    return [[b["image"] for b in loader] for _ in range(n)]


def _assert_same(got, want):
    assert len(got) == len(want) and all(len(g) == len(w) for g, w in zip(got, want))
    for g_epoch, w_epoch in zip(got, want):
        for g, w in zip(g_epoch, w_epoch):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert not all(np.array_equal(a, b) for a, b in zip(got[0], got[1]))  # epoch_tag moved


def test_ssl_loader_synthetic_is_bitwise_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = dict(SSL_CFG, root_path=str(tmp_path / "none"), synthetic_size=10)
    port = t_ssl.SSLLoader(cfg, seed=3)
    try:
        got = _epochs(port)
    finally:
        port.close()
    want = _epochs(j_ssl.SSLLoader(cfg, seed=3))
    assert len(got[0]) == 2 and got[0][0].shape == (4, 32, 32, 6)
    _assert_same(got, want)
    n = dict(cfg, num_samples_per_epoch=6)
    assert len(t_ssl.SSLLoader(n)) == len(j_ssl.SSLLoader(n)) == 1


def _write_corpus(root, rs):
    """data/<event>/<folder>/<subfolder>/<hash>/ tiles (vv, vh of three
    acquisitions) at 40x48, a ``.gpkg`` entry the walk skips, and a
    subfolder and a folder that hold tiles directly (each listed once for
    each file)."""
    import cv2

    def tiles(d):
        d.mkdir(parents=True, exist_ok=True)
        for prefix in ("MS1_IVV", "MS1_IVH", "SL1_IVV", "SL1_IVH", "SL2_IVV", "SL2_IVH"):
            img = rs.gamma(2.0, 0.03, (40, 48)).astype(np.float32)
            img[rs.rand(40, 48) < 0.01] = np.nan
            assert cv2.imwrite(str(d / f"{prefix}_tile.tif"), img)

    for e, event in enumerate(("ev_a", "ev_b")):
        for h in range(3):
            tiles(root / "data" / event / "grid_1" / "sub_0" / f"hash_{h}")
        (root / "data" / event / "areas.gpkg").mkdir(parents=True)
    tiles(root / "data" / "ev_b" / "grid_2" / "flat")
    tiles(root / "data" / "ev_a" / "grid_3")


def test_ssl_loader_written_corpus_is_bitwise_jax(tmp_path, monkeypatch):
    _write_corpus(tmp_path / "corpus", np.random.RandomState(0))
    cfg = dict(SSL_CFG, root_path=str(tmp_path / "corpus"))
    out = {}
    for name, cls in (("port", t_ssl.SSLLoader), ("jax", j_ssl.SSLLoader)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)  # each package's own ssl_samples.pkl
        loader = cls(cfg, seed=5)
        assert not loader.synthetic and (tmp_path / name / "ssl_samples.pkl").is_file()
        out[name] = (list(loader.samples), _epochs(loader))
        if name == "port":
            loader.close()
    assert out["port"][0] == out["jax"][0]
    assert len(out["port"][0]) == 6 + 6 + 6  # 3 hashes x 2 events, 6 files twice
    _assert_same(out["port"][1], out["jax"][1])
    # the cache: a sample added after the first walk is not listed
    monkeypatch.chdir(tmp_path / "port")
    (tmp_path / "corpus" / "data" / "ev_a" / "grid_1" / "sub_0" / "hash_9").mkdir()
    assert t_ssl.walk_ssl_samples(cfg["root_path"]) == out["port"][0]
    with pytest.raises(ValueError, match="per-channel for 2 channels"):
        t_ssl.SSLDecoder(dict(cfg, channels=["vv", "vh", "vh/vv"]), out["port"][0], 5,
                         False).read_stack(0)


# ---------------------------------------------------------------- the epoch loop

def _loop_cfg(path, **kw):
    return {"task": "mae", "method": "mae", "checkpoint_path": str(path / "mae"),
            "root_path": str(path / "none"), "synthetic_size": 16, "synthetic_patch_size": 64,
            "num_channels": 6, "batch_size": 8, "num_workers": 2, "channels": ["vv", "vh"],
            "clamp_input": 0.15, "epochs": 2, "mixed_precision": False, "print_frequency": 1,
            **kw}


def _names(ckpt):
    return {n for n in ("mae_0", "vit_0", "mae_1", "vit_1") if ckpt.has(n)}


def _recording(module, monkeypatch):
    """Records the learning rates the schedule of ``module.train`` returns."""
    lrs = []
    real = module.mae_warmup_cosine

    def recorded(*a, **kw):
        schedule = real(*a, **kw)
        return lambda e: lrs.append(schedule(e)) or lrs[-1]

    monkeypatch.setattr(module, "mae_warmup_cosine", recorded)
    return lrs


@pytest.fixture(scope="module")
def jax_loop(tmp_path_factory):
    """JAX's train() over 2 epochs of 2 steps (and a run capped at 3
    steps), its init and step compiled with FAST_COMPILE: its initial
    parameters, learning rates, losses, final parameters, checkpoint names,
    and the masking noise each microbatch drew (make_rng("mask") under the
    step's keys, C7)."""
    from kurosiwo_tpu.models.factory import build_mae as j_build_mae
    from kurosiwo_tpu.training.checkpoint import CheckpointManager

    path = tmp_path_factory.mktemp("jax_mae")
    mp = pytest.MonkeyPatch()
    mp.chdir(path)
    init = {}
    real_state = j_mae.create_train_state

    def recording_state(model, *a, **kw):
        state, v = real_state(FastInit(model), *a, **kw)
        init["params"] = jax.tree.map(np.array, dict(state.params))
        return state, v

    mp.setattr(j_mae, "create_train_state", recording_state)
    mp.setattr(j_mae, "jax", FastJax())
    try:
        lrs = _recording(j_mae, mp)
        losses = []
        cfg = _loop_cfg(path)
        state = j_mae.train(cfg, seed=1, model_configs=MCFG, record_losses=losses)
        lrs = list(lrs)
        names = _names(CheckpointManager(cfg["checkpoint_path"]))
        capped_cfg = _loop_cfg(path / "capped")
        capped = j_mae.train(capped_cfg, seed=1, model_configs=MCFG, max_steps=3)
        capped_names = _names(CheckpointManager(capped_cfg["checkpoint_path"]))
    finally:
        mp.undo()
    model = j_build_mae(dict(cfg, **MCFG), dict(cfg, **MCFG))
    v = {"params": jax.tree.map(jnp.asarray, init["params"])}
    rng, noise = jax.random.PRNGKey(1), []
    images = np.zeros((2, 64, 64, 6), np.float32)
    for _ in range(len(losses)):
        rng, step_rng = jax.random.split(rng)
        for r in jax.random.split(step_rng, MCFG["accumulate_gradients"]):
            key = model.apply(v, images, rngs={"mask": r}, method=lambda m, _: m.make_rng("mask"))
            noise.append(np.array(jax.random.uniform(key, (4, N))))
    return {"init": init["params"], "lrs": lrs, "losses": losses, "names": names,
            "params": jax.tree.map(np.asarray, dict(state.params)), "noise": noise,
            "capped_names": capped_names, "capped_step": int(capped.step)}


def _port_loop(path, jax_loop, monkeypatch, **kw):
    """The port's train() from JAX's initial parameters, fed JAX's noise."""
    real_build, real_step = t_mae.build_mae, t_mae.make_mae_train_step
    noise = iter(jax_loop["noise"])

    def build(*a, **k):
        model = real_build(*a, **k)
        model.load_state_dict(flax_to_torch({"params": jax_loop["init"]}))
        return model

    def make_step(*a, **k):
        step = real_step(*a, **k)
        accum = MCFG["accumulate_gradients"]
        return lambda state, batch, lr, gen: step(
            state, batch, lr, gen, noise=torch.from_numpy(np.stack([next(noise)
                                                                    for _ in range(accum)])))

    monkeypatch.setattr(t_mae, "build_mae", build)
    monkeypatch.setattr(t_mae, "make_mae_train_step", make_step)
    lrs, losses = _recording(t_mae, monkeypatch), []
    cfg = _loop_cfg(path)
    state = t_mae.train(cfg, seed=1, model_configs=MCFG, record_losses=losses, device="cpu", **kw)
    return cfg, state, lrs, losses


def test_mae_loop_matches_jax(tmp_path, monkeypatch, jax_loop, capsys):
    monkeypatch.chdir(tmp_path)
    cfg, state, lrs, losses = _port_loop(tmp_path, jax_loop, monkeypatch)
    out = capsys.readouterr().out
    assert "MAE epoch 1 iter 1: loss=" in out and "MAE epoch 1: " in out
    assert lrs == jax_loop["lrs"] and len(lrs) == 4 and lrs[0] == 0.0
    assert state.step == 4
    np.testing.assert_allclose(losses[:2], jax_loop["losses"][:2], rtol=1e-4)
    np.testing.assert_allclose(losses[2:], jax_loop["losses"][2:], rtol=2e-3)
    got = torch_to_flax(state.model.state_dict())["params"]
    want = jax_loop["params"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    d = np.concatenate([np.abs(g - w).ravel()
                        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want))])
    total = sum(lrs)
    assert d.max() <= 2 * total + 1e-7 and np.mean(d <= 0.3 * total) >= 0.99
    ckpt = TCheckpoints(cfg["checkpoint_path"])
    assert _names(ckpt) == jax_loop["names"] == {"mae_0", "vit_0", "mae_1", "vit_1"}
    payload, _ = ckpt.load("mae_1")
    assert payload["step"] == 4 and "optimizer" in payload
    vit, _ = ckpt.load("vit_1")
    assert "optimizer" not in vit and set(vit["model"]) == set(state.model.encoder.state_dict())
    enc = torch_to_flax(vit["model"])["params"]
    assert jax.tree_util.tree_structure(enc) == jax.tree_util.tree_structure(want["encoder"])
    for g, w in zip(jax.tree.leaves(enc), jax.tree.leaves(got["encoder"])):
        np.testing.assert_array_equal(g, w)


def test_mae_loop_max_steps_stops_as_jax(tmp_path, monkeypatch, jax_loop):
    """``max_steps`` 3 over epochs of 2 steps: epoch 0 whole (mae_0, vit_0),
    one step of epoch 1, then mae_1 alone and the end of the run."""
    monkeypatch.chdir(tmp_path)
    cfg, state, _, losses = _port_loop(tmp_path, jax_loop, monkeypatch, max_steps=3)
    assert state.step == jax_loop["capped_step"] == 3 and len(losses) == 3
    assert _names(TCheckpoints(cfg["checkpoint_path"])) == jax_loop["capped_names"] == {
        "mae_0", "vit_0", "mae_1"}


def test_mae_learns(tmp_path, monkeypatch):
    """tests/test_learning.py::test_mae_learns on the port alone: 20 steps
    at lr 1e-3, the mean loss of the last 4 below that of the first 4."""
    monkeypatch.chdir(tmp_path)
    cfg = _loop_cfg(tmp_path, epochs=10, print_frequency=10_000)
    mcfg = dict(MCFG, accumulate_gradients=1, learning_rate=1e-3)
    losses: list[float] = []
    t_mae.train(cfg, seed=1, model_configs=mcfg, max_steps=20, record_losses=losses,
                device="cpu")
    assert len(losses) >= 12 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses


def test_mae_train_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_mae.train(_loop_cfg(tmp_path), seed=1, model_configs=MCFG)
    assert not os.path.exists(tmp_path / "mae")
