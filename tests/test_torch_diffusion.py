"""The port's diffusion model (kurosiwo_torch.models.diffusion) against the
JAX package's, on the CPU at a tiny size: dim 8, dim_mults (1, 2), 32x32x2,
batch 2, 10 timesteps (5 for the sampler). The weights are the port's
seeded init with every bias and GroupNorm affine perturbed, carried to
flax by ``convert.torch_to_flax``; the timesteps and noise are
``jax.random``'s, fed to the port (ROADMAP C15's rule). One jitted JAX run
(``jax_run``, at XLA's lowest optimization level) gives every reference
value.

Exactness classes (ROADMAP C5):
- bit-exact: the state_dict's names and shapes against the flax tree (a
  conv bias the port's ``ops/nn.Conv`` default would drop is a missing
  name); the schedule against ``jnp.linspace`` and ``jnp.cumprod``;
- cross-framework banded, f32 (atol 5e-4; the time MLP 1e-5): the time embedding,
  ``ResnetBlock`` (also at an input of variance 1e-6, where GroupNorm's
  epsilon decides the scale), ``LinearAttention``, ``DDPMUnet``, the loss
  and every gradient (each within 5e-4 of its tensor's largest value, plus
  5e-4 absolute) and a 5-step ``sample`` chain;
- bf16 (the compute dtype under ``mixed_precision``, on f32 parameters):
  the loss within 2% of JAX's bf16 loss; the gradients against JAX's f32
  ones (each within 2% of the tree's largest gradient, all within 5% in L2
  and no further than JAX's bf16 gradients are) and within 10% in L2 of
  JAX's bf16 ones.
The traps where the port's defaults differ from flax's each have an
assertion that fails with the port's default: ``F.gelu``'s exact form for
flax's tanh approximation, ``ops/nn.GroupNorm``'s epsilon 1e-5 for 1e-6,
a conv without its bias; and the dtypes (f32 parameters, embedding and
loss; bf16 activations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kurosiwo_torch.convert import torch_to_flax
from kurosiwo_torch.models import diffusion as tdiff
from kurosiwo_torch.models.factory import initialize_segmentation_model as t_init
from kurosiwo_tpu.models import diffusion as jdiff
from torch_cd_parity import jit_fast, tree

torch.set_num_threads(2)

DIM, MULTS, T, SIDE, B = 8, (1, 2), 10, 32, 2
T_SAMPLE = 5
ATOL = 5e-4
TEMB_ATOL = 1e-5  # the time MLP alone: two Dense layers of 8 and 32 inputs
CFG = {"task": "diffusion-unsup", "method": "diffusion", "mixed_precision": False}
MCFG = {"dim": DIM, "dim_mults": list(MULTS), "timesteps": T}


def _port(dtype=torch.float32, timesteps=T, seed=0):
    """The port's DDPM from the factory with every bias and GroupNorm affine
    perturbed (flax initialises them to 0 and 1)."""
    model = t_init(dict(CFG, mixed_precision=dtype == torch.bfloat16),
                   dict(MCFG, timesteps=timesteps), device="cpu", seed=seed)
    rs = np.random.RandomState(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(torch.from_numpy(1 + 0.2 * rs.randn(*p.shape).astype(np.float32)))
            elif name.endswith("bias"):
                p.copy_(torch.from_numpy(0.1 * rs.randn(*p.shape).astype(np.float32)))
    return model


def _jax(dtype=jnp.float32, timesteps=T):
    return jdiff.GaussianDiffusion(model=jdiff.DDPMUnet(dim=DIM, dim_mults=MULTS, channels=2,
                                                         dtype=dtype), timesteps=timesteps)


def _draws(rng, shape):
    """GaussianDiffusion.__call__'s draws under ``rng``: t and noise."""
    kt, kn = jax.random.split(rng)
    return (np.asarray(jax.random.randint(kt, (shape[0],), 0, T)),
            np.asarray(jax.random.normal(kn, shape, jnp.float32)))


def _sample_draws(rng, shape):
    """GaussianDiffusion.sample's draws under ``rng``: x_T, then one noise a
    step (the last one unused, at t = 0)."""
    k0, key = jax.random.split(rng)
    out = [jax.random.normal(k0, shape)]
    for _ in range(T_SAMPLE):
        key, kn = jax.random.split(key)
        out.append(jax.random.normal(kn, shape))
    return np.stack([np.asarray(x) for x in out])


def _block_input(rs, scale=1.0):
    return (scale * rs.randn(B, 8, 8, 8)).astype(np.float32), rs.randn(B, 4 * DIM).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_run():
    """Every JAX value the tests compare with, from the port's weights."""
    rs = np.random.RandomState(0)
    v = torch_to_flax(_port().state_dict())
    params = jax.tree.map(jnp.asarray, v["params"])
    x0 = rs.randn(B, SIDE, SIDE, 2).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    out = {"params": v["params"], "x0": x0, "draws": _draws(rng, x0.shape)}

    # a ResnetBlock widening 8 -> 16 (its shortcut conv) and the attention,
    # on the UNet's own weights (ResnetBlock_2 and LinearAttention_0)
    up = params["model"]
    block = jdiff.ResnetBlock(2 * DIM)
    blk = {"params": up["ResnetBlock_2"]}
    for tag, scale in (("block", 1.0), ("block_small", 1e-3)):
        xb, temb = _block_input(np.random.RandomState(1), scale)
        out[tag] = (xb, temb, np.asarray(jit_fast(lambda p, a, c: block.apply(p, a, c),
                                                  blk, xb, temb)))
    xa = rs.randn(B, 16, 16, 2 * DIM).astype(np.float32)
    attn = jdiff.LinearAttention()
    out["attn"] = (xa, np.asarray(jit_fast(lambda p, a: attn.apply(p, a),
                                           {"params": up["LinearAttention_0"]}, xa)))

    # the UNet on q_sample's input, with its time MLP's output
    t, noise = out["draws"]
    unet = jdiff.DDPMUnet(dim=DIM, dim_mults=MULTS, channels=2)

    def unet_fn(p, x, tt):
        eps, state = unet.apply({"params": p}, x, tt, capture_intermediates=True)
        return eps, state["intermediates"]["Dense_1"]["__call__"][0]

    out["unet"] = tree(dict(zip(("eps", "temb"), jit_fast(unet_fn, up, x0, t))))

    # the loss and every gradient, f32 and bf16
    for tag, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        model = _jax(dt)
        loss, grads = jit_fast(jax.value_and_grad(
            lambda p, x, r: model.apply({"params": p}, x, rng=r)), params, x0, rng)
        out[tag] = (float(loss), tree(grads))

    # a 5-step chain
    srng = jax.random.PRNGKey(4)
    sampler = _jax(timesteps=T_SAMPLE)
    out["sample"] = (_sample_draws(srng, (1, SIDE, SIDE, 2)), np.asarray(jit_fast(
        lambda p, r: sampler.apply({"params": p}, r, (1, SIDE, SIDE, 2), method=sampler.sample),
        params, srng)))
    return out


def test_names_and_shapes_are_the_flax_tree():
    """Every conv keeps its bias but the qkv projection: with
    ``ops/nn.Conv``'s default (no bias) a name would be missing."""
    x = jnp.zeros((B, SIDE, SIDE, 2))
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: _jax().init({"params": rng}, x, rng=rng))
    want = jax.tree.map(lambda s: s.shape, dict(shapes["params"]))
    got = jax.tree.map(np.shape, torch_to_flax(_port().state_dict())["params"])
    assert got == want
    biases = [k for k in _port().state_dict() if k.endswith(".bias") and ".Conv_" in k]
    convs = [k for k in _port().state_dict() if k.endswith(".weight") and ".Conv_" in k]
    assert len(convs) - len(biases) == 1 and "model.LinearAttention_0.Conv_0.bias" not in biases


def test_schedule_is_jax_linspace_and_cumprod():
    model = _port()
    betas = jnp.linspace(1e-4, 0.02, T)
    np.testing.assert_array_equal(model.betas.numpy(), np.asarray(betas))
    np.testing.assert_allclose(model.acp.numpy(), np.asarray(jnp.cumprod(1.0 - betas)),
                               rtol=1e-6)


def test_time_embedding_matches_jax():
    t = np.array([0, 3, 9, 999])
    got = tdiff.sinusoidal_time_embedding(torch.from_numpy(t), 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jdiff.sinusoidal_time_embedding(
        jnp.asarray(t), 64)), atol=ATOL)


def _resnet_block(params):
    block = tdiff.ResnetBlock(DIM, 2 * DIM, 4 * DIM)
    block.load_state_dict(_state(params["model"]["ResnetBlock_2"]))
    return block


def _state(flax_params):
    from kurosiwo_torch.convert import flax_to_torch

    return flax_to_torch({"params": flax_params})


@pytest.mark.parametrize("tag", ["block", "block_small"])
def test_resnet_block_matches_flax(jax_run, tag):
    """At an input of variance 1e-6 ("block_small") GroupNorm's epsilon sets
    the scale: ``ops/nn.GroupNorm``'s default 1e-5 misses flax's 1e-6 there."""
    xb, temb, want = jax_run[tag]
    block = _resnet_block(jax_run["params"])
    got = block(torch.from_numpy(xb), torch.from_numpy(temb), torch.float32).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    if tag == "block_small":
        block.GroupNorm_0.eps = block.GroupNorm_1.eps = 1e-5
        wrong = block(torch.from_numpy(xb), torch.from_numpy(temb), torch.float32)
        assert np.abs(wrong.detach().numpy() - want).max() > 100 * ATOL


def test_linear_attention_matches_flax(jax_run):
    xa, want = jax_run["attn"]
    attn = tdiff.LinearAttention(2 * DIM)
    attn.load_state_dict(_state(jax_run["params"]["model"]["LinearAttention_0"]))
    got = attn(torch.from_numpy(xa), torch.float32).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _unet_outputs(model, x0, t):
    """The UNet's eps on q_sample(x0, t, noise) and its time MLP's output."""
    seen = {}
    hook = model.model.Dense_1.register_forward_hook(lambda m, i, o: seen.update(temb=o))
    with torch.no_grad():
        eps = model.model(torch.from_numpy(x0), torch.from_numpy(t))
    hook.remove()
    return eps.numpy(), seen["temb"].numpy()


def test_unet_matches_flax_and_its_gelu_is_tanh(jax_run, monkeypatch):
    """The UNet's output and its time MLP's against flax (the MLP within
    1e-5); with ``F.gelu``'s default (exact) form the MLP leaves that band
    ten times over: flax's ``nn.gelu`` is the tanh approximation."""
    model = _port()
    t, _ = jax_run["draws"]
    eps, temb = _unet_outputs(model, jax_run["x0"], t)
    np.testing.assert_allclose(temb, jax_run["unet"]["temb"], atol=TEMB_ATOL)
    np.testing.assert_allclose(eps, jax_run["unet"]["eps"], atol=ATOL)
    exact = F.gelu
    monkeypatch.setattr(F, "gelu", lambda x, approximate="none": exact(x))
    _, wrong = _unet_outputs(model, jax_run["x0"], t)
    assert np.abs(wrong - jax_run["unet"]["temb"]).max() > 10 * TEMB_ATOL


def _loss_and_grads(model, jax_run):
    t, noise = jax_run["draws"]
    model.zero_grad(set_to_none=True)
    loss = model(torch.from_numpy(jax_run["x0"]), t=torch.from_numpy(t),
                 noise=torch.from_numpy(noise))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return loss, torch_to_flax(grads)["params"]


def test_loss_and_every_gradient_match_jax_f32(jax_run):
    model = _port()
    loss, grads = _loss_and_grads(model, jax_run)
    want_loss, want = jax_run["f32"]
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL)
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=ATOL * np.abs(w).max() + ATOL)


def test_loss_and_every_gradient_match_jax_bf16(jax_run):
    """bf16 compute on f32 parameters: the UNet's output is bf16, the
    parameters, their gradients and the loss f32. The gradients are held
    to the f32 gradient: JAX's bf16 ones sum the bias gradients in bf16 and
    lie 3x further from it (7% against 2% in L2 here), so the port's must
    lie no further than JAX's, within 5% in L2, and within 10% of JAX's."""
    model = _port(torch.bfloat16)
    t, _ = jax_run["draws"]
    with torch.no_grad():
        assert model.model(torch.from_numpy(jax_run["x0"]),
                           torch.from_numpy(t)).dtype == torch.bfloat16
    loss, grads = _loss_and_grads(model, jax_run)
    assert loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    want_loss, want16 = jax_run["bf16"]
    np.testing.assert_allclose(loss.item(), want_loss, rtol=2e-2)
    got, j16, j32 = (jax.tree.leaves(x) for x in (grads, want16, jax_run["f32"][1]))

    def l2(xs, ys):
        return np.sqrt(sum(float(np.square(x - y).sum()) for x, y in zip(xs, ys)))

    norm = l2(j32, [np.zeros_like(x) for x in j32])
    assert l2(got, j32) <= min(5e-2 * norm, l2(j16, j32))
    assert l2(got, j16) <= 1e-1 * norm
    largest = max(np.abs(x).max() for x in j32)
    for g, w in zip(got, j32):
        assert np.abs(g - w).max() <= 2e-2 * largest


def test_sample_matches_jax(jax_run):
    """A 5-step ancestral chain from JAX's draws: x_T, a noise a step, none
    added at t = 0."""
    noises, want = jax_run["sample"]
    model = _port(timesteps=T_SAMPLE)
    got = model.sample((1, SIDE, SIDE, 2), noises=torch.from_numpy(noises))
    assert got.dtype == torch.float32 and got.shape == (1, SIDE, SIDE, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # the last draw is not used: no noise at t = 0
    again = model.sample((1, SIDE, SIDE, 2), noises=torch.from_numpy(
        np.concatenate([noises[:-1], 5 * noises[-1:]])))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_sample_from_a_generator_is_seeded():
    model = _port(timesteps=3)
    a = model.sample((1, 16, 16, 2), generator=torch.Generator().manual_seed(5))
    b = model.sample((1, 16, 16, 2), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_factory_reads_the_model_config():
    """dim, dim_mults and timesteps from the model config, 2 channels, the
    L1 loss, the compute dtype of ``mixed_precision``; the method is not
    read (main.py runs the task with ``--method diffusion``)."""
    model = t_init({"task": "diffusion-unsup", "method": "unet"},
                   {"dim": 16, "dim_mults": [1, 2, 4], "timesteps": 7}, device="cpu")
    assert isinstance(model, tdiff.GaussianDiffusion) and model.loss_type == "l1"
    assert model.timesteps == 7 and model.dtype == torch.bfloat16 and model.model.dim == 16
    assert model.model.Conv_0.weight.shape == (16, 2, 7, 7)
    assert model.model.ResnetBlock_4.Conv_0.weight.shape == (64, 32, 3, 3)
