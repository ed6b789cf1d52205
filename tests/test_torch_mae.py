"""Port parity of the MAE (FloodViT) slice: kurosiwo_torch's LayerNorm, ViT,
MAE, flax<->torch bridge, bf16-moment Adam, schedule and train step against
the JAX package, on the CPU at a tiny size (image 64, patch 16, dim 64,
depth 2, heads 2, dim_head 64, decoder 32 x 1 layer, 2 heads: N = 16
patches, 4 kept, H*D = 128, so attention takes the short-kernel route, whose
plain version runs here).

Exactness classes (ROADMAP C5):
  * bit-exact: the flax<->torch round trip; the schedule;
  * cross-framework banded, f32: LayerNorm forward and backward atol 1e-5;
    ViT tokens atol 1e-4 (LayerNorms of 1,536-wide patches and 2 blocks);
    MAE loss rtol 1e-5; one Adam step with bf16 moments on identical
    gradients, every element within 1e-2 * lr (a moment can round to the
    other side of a bf16 boundary);
  * the train step (ROADMAP C6): loss rtol 1e-4; parameters all within 2*lr
    and 99% within 0.3*lr, since Adam's first update is about lr*sign(g)
    and a near-zero gradient may differ in sign between the frameworks;
    first moments within 5% of each tensor's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.models.factory import build_mae as t_build_mae
from kurosiwo_torch.models.vit import ViT as TViT
from kurosiwo_torch.models.vit import patchify as t_patchify
from kurosiwo_torch.models.vit import unpatchify as t_unpatchify
from kurosiwo_torch.ops import optim as t_optim
from kurosiwo_torch.ops import schedules as t_schedules
from kurosiwo_torch.ops.layernorm import LayerNorm as TLayerNorm
from kurosiwo_torch.training.mae import make_mae_train_step as t_mae_step
from kurosiwo_torch.training.state import create_train_state as t_create_state
from kurosiwo_tpu.models.factory import build_mae as j_build_mae
from kurosiwo_tpu.models.vit import ViT as JViT
from kurosiwo_tpu.models.vit import patchify as j_patchify
from kurosiwo_tpu.ops import optim as j_optim
from kurosiwo_tpu.ops import schedules as j_schedules
from kurosiwo_tpu.ops.fused_ln import LayerNorm as JLayerNorm
from kurosiwo_tpu.training.mae import make_mae_train_step as j_mae_step
from kurosiwo_tpu.training.state import create_train_state as j_create_state

torch.set_num_threads(2)

B, SIZE, CH = 4, 64, 6
CFG = {"num_channels": CH, "mixed_precision": False}
MCFG = {"image_size": SIZE, "patch_size": 16, "dim": 64, "depth": 2, "heads": 2,
        "mlp_dim": 128, "decoder_dim": 32, "decoder_depth": 1, "decoder_heads": 2,
        "masked_ratio": 0.75}
N = (SIZE // 16) ** 2
LR = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, dict(tree))


def _images(seed, b=B):
    return np.random.RandomState(seed).randn(b, SIZE, SIZE, CH).astype(np.float32)


@pytest.fixture(scope="module")
def jax_mae():
    model = j_build_mae(CFG, MCFG)
    x = jnp.asarray(_images(0))
    variables = jax.jit(lambda r: model.init({"params": r, "mask": r}, x))(jax.random.PRNGKey(0))
    return model, {"params": _np_tree(variables["params"])}


def _torch_mae(variables):
    model = t_build_mae(CFG, MCFG, device="cpu")
    model.load_state_dict(flax_to_torch(variables))
    return model


# ---------------------------------------------------------------- LayerNorm

@pytest.mark.parametrize("in_dtype,out_dtype", [("f32", "f32"), ("f32", "bf16"),
                                                ("bf16", "bf16")])
def test_layernorm_matches_fused_ln(in_dtype, out_dtype):
    rs = np.random.RandomState(1)
    x = (rs.randn(3, 5, 48) * 2 + 0.5).astype(np.float32)
    dy = rs.randn(3, 5, 48).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(48)).astype(np.float32)
    bias = (0.1 * rs.randn(48)).astype(np.float32)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    jx = jnp.asarray(x, jdt[in_dtype])
    ln = JLayerNorm(dtype=jdt[out_dtype])
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    y, vjp = jax.vjp(lambda p, xx: ln.apply(p, xx), params, jx)
    jgp, jgx = vjp(jnp.asarray(dy, jdt[out_dtype]))

    mod = TLayerNorm(48)
    mod.scale.data = torch.from_numpy(scale)
    mod.bias.data = torch.from_numpy(bias)
    tx = torch.from_numpy(x).to(tdt[in_dtype]).requires_grad_(True)
    ty = mod(tx, tdt[out_dtype])
    assert ty.dtype == tdt[out_dtype]
    ty.backward(torch.from_numpy(dy).to(tdt[out_dtype]))
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    if out_dtype == "f32" and in_dtype == "f32":
        tol = 1e-5
    else:  # one bf16 rounding of values up to ~4: 2^-8 relative
        tol = 2e-2
    np.testing.assert_allclose(ty.detach().float().numpy(), f(y), atol=tol, rtol=0)
    np.testing.assert_allclose(tx.grad.float().numpy(), f(jgx), atol=tol, rtol=0)
    gtol = 1e-4 if tol == 1e-5 else 0.5  # sums of 15 products of bf16-rounded dy
    np.testing.assert_allclose(mod.scale.grad.numpy(), f(jgp["params"]["scale"]), atol=gtol)
    np.testing.assert_allclose(mod.bias.grad.numpy(), f(jgp["params"]["bias"]), atol=gtol)


# ---------------------------------------------------------------- ViT

@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_matches_jax(pool):
    kw = dict(image_size=SIZE, patch_size=16, num_classes=5, dim=64, depth=2, heads=2,
              mlp_dim=128, channels=CH, pool=pool)
    jm = JViT(**kw)
    x = _images(2, b=2)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tm = TViT(**kw)
    tm.load_state_dict(flax_to_torch({"params": _np_tree(variables["params"])}))
    tx = torch.from_numpy(x)
    want_tokens = jm.apply(variables, jnp.asarray(x), method=JViT.embed_image)
    got_tokens = tm.embed_image(tx)
    np.testing.assert_allclose(got_tokens.detach().numpy(), np.asarray(want_tokens), atol=1e-4)
    want_patch = jm.apply(variables, j_patchify(jnp.asarray(x), 16), method=JViT.embed_patches)
    got_patch = tm.embed_patches(t_patchify(tx, 16))
    np.testing.assert_allclose(got_patch.detach().numpy(), np.asarray(want_patch), atol=1e-4)
    want = jm.apply(variables, jnp.asarray(x))
    got = tm(tx)
    assert got.shape == want.shape == ((2, N, 64) if pool == "cls" else (2, 5))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


def test_patchify_roundtrip_and_order():
    x = _images(4, b=1)
    np.testing.assert_array_equal(t_patchify(torch.from_numpy(x), 16).numpy(),
                                  np.asarray(j_patchify(jnp.asarray(x), 16)))
    back = t_unpatchify(t_patchify(torch.from_numpy(x), 16), 16, SIZE, SIZE, CH)
    np.testing.assert_array_equal(back.numpy(), x)


# ---------------------------------------------------------------- MAE

def test_mae_tree_roundtrip_is_bit_exact(jax_mae):
    _, variables = jax_mae
    model = _torch_mae(variables)
    state = model.state_dict()
    flat = {".".join(p.key for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    renamed = {k.replace("kernel", "weight") for k in flat}
    assert set(state) == renamed
    back = torch_to_flax(state)
    assert set(back["batch_stats"]) == set()
    assert jax.tree_util.tree_structure(back["params"]) == \
        jax.tree_util.tree_structure(variables["params"])
    for g, w in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(variables["params"])):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # Dense kernels are (in, out) in flax, (out, in) in torch
    assert state["encoder.transformer.attn_1.to_qkv.weight"].shape == (384, 64)
    assert state["decoder_pos_emb.embedding"].shape == (N, 32)


def test_mae_loss_matches_jax_with_the_same_noise(jax_mae):
    model, variables = jax_mae
    x = _images(5)
    rng = jax.random.PRNGKey(7)
    want = float(model.apply(variables, jnp.asarray(x), rng))
    noise = np.array(jax.random.uniform(rng, (B, N)))  # what mae.py:62 draws
    got = _torch_mae(variables)(torch.from_numpy(x), torch.from_numpy(noise))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)


def test_bf16_mae_keeps_f32_masters_and_close_loss(jax_mae):
    model, variables = jax_mae
    x = _images(5)
    rng = jax.random.PRNGKey(7)
    want = float(model.apply(variables, jnp.asarray(x), rng))
    noise = torch.from_numpy(np.array(jax.random.uniform(rng, (B, N))))
    tm = t_build_mae(dict(CFG, mixed_precision=True), MCFG, device="cpu")
    tm.load_state_dict(flax_to_torch(variables))
    assert tm.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    got = tm(torch.from_numpy(x), noise)
    # bf16 compute rounds at every product: a loose band on the loss only
    np.testing.assert_allclose(float(got.detach()), want, rtol=2e-2)


# ---------------------------------------------------------------- optimizer, schedule

def test_mae_warmup_cosine_matches_jax():
    j = j_schedules.mae_warmup_cosine(1e-4, 1e-6, warmup_epochs=10, total_epochs=100)
    t = t_schedules.mae_warmup_cosine(1e-4, 1e-6, warmup_epochs=10, total_epochs=100)
    for e in (0, 0.5, 3.25, 9.999, 10, 10.5, 55, 99.9, 100):
        assert t(e) == j(e)


def test_adam_bf16_moments_matches_jax():
    rs = np.random.RandomState(8)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) * 10.0 ** -k for s in shapes] for k in range(3)]
    tx = j_optim.adam_bf16_moments(LR)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = t_optim.AdamBF16Moments(tp, lr=LR)
    for gs in grads:
        upd, opt_state = tx.update([jnp.asarray(g, jnp.bfloat16) for g in gs], opt_state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        opt.step()
    for p, w in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-2 * LR, rtol=0)
    mu = opt_state[0].mu
    for p, w in zip(tp, mu):
        m = opt.state[p]["exp_avg"]
        assert m.dtype == torch.bfloat16
        np.testing.assert_allclose(m.float().numpy(), np.asarray(w, np.float32),
                                   rtol=1e-2, atol=1e-6)


def test_create_optimizer_mae_defaults_to_bf16_moments():
    p = [torch.nn.Parameter(torch.zeros(3))]
    assert isinstance(t_optim.create_optimizer(p, {}, {}, task="mae"), t_optim.AdamBF16Moments)
    f32 = t_optim.create_optimizer(p, {"optimizer_moment_dtype": "float32"}, {}, task="mae")
    assert type(f32) is torch.optim.Adam
    assert t_optim.resolve_moment_dtype({}, {}, "mae") == j_optim.resolve_moment_dtype({}, {}, "mae")
    with pytest.raises(NotImplementedError, match="A8"):
        t_optim.create_optimizer(p, {}, {"lr_scales": {"x": 0.5}}, task="mae")


# ---------------------------------------------------------------- train step

def _first_moment(opt_state):
    return opt_state.inner_state[0].mu


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(jax_mae, accum):
    model, variables = jax_mae
    tx = j_optim.create_optimizer(CFG, {"learning_rate": LR}, task="mae")
    state, _ = j_create_state(model, tx, jax.random.PRNGKey(0), (jnp.zeros((2, SIZE, SIZE, CH)),))
    state = state.replace(params=jax.tree.map(jnp.asarray, variables["params"]))
    x = _images(9)
    rng = jax.random.PRNGKey(11)
    step = jax.jit(j_mae_step(model, tx, accum))
    new_state, loss = step(state, {"image": jnp.asarray(x)}, jnp.asarray(LR, jnp.float32), rng)

    # the noise each microbatch drew inside the JAX step: make_rng("mask")
    # under rngs={"mask": r}, recovered, then checked to reproduce the loss
    micro = B // accum
    noise, losses = [], []
    for i, r in enumerate(jax.random.split(rng, accum)):
        imgs = jnp.asarray(x[i * micro:(i + 1) * micro])
        key = model.apply(variables, imgs, rngs={"mask": r}, method=lambda m, _: m.make_rng("mask"))
        np.testing.assert_allclose(float(model.apply(variables, imgs, key)),
                                   float(model.apply(variables, imgs, rngs={"mask": r})), rtol=1e-6)
        noise.append(np.array(jax.random.uniform(key, (micro, N))))
        losses.append(float(model.apply(variables, imgs, key)))
    np.testing.assert_allclose(float(loss), np.mean(losses), rtol=1e-5)

    tm = _torch_mae(variables)
    tstate = t_create_state(tm, CFG, {"learning_rate": LR}, task="mae")
    tstep = t_mae_step(tm, accum=accum, device="cpu")
    tstate, tloss = tstep(tstate, {"image": x}, LR, noise=np.stack(noise))
    assert tstate.step == 1
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)

    got = torch_to_flax(tm.state_dict())["params"]
    want = _np_tree(new_state.params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(jax.tree.leaves(got),
                                                             jax.tree.leaves(want))])
    assert d.max() <= 2 * LR + 1e-7
    assert np.mean(d <= 0.3 * LR) >= 0.99
    mu = {name: tstate.optimizer.state[p]["exp_avg"].float()
          for name, p in tm.named_parameters()}
    got_mu = torch_to_flax(mu)["params"]
    for g, w in zip(jax.tree.leaves(got_mu), jax.tree.leaves(_first_moment(new_state.opt_state))):
        w = np.asarray(w, np.float32)
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max() + 1e-12
