"""Port parity of the convolutional change-detection models: SNUNet-ECAM
(base_channel 8), Siam-diff, Siam-conc (at 36x36, where the decoder's
replication pad acts) and ADHR-CDNet against kurosiwo_tpu's, the same
weights carried through kurosiwo_torch.convert (HFA-Net, which fits 224x224
only, is tests/test_torch_cd_hfanet.py).

Exactness classes (ROADMAP C5): the weight bridge bit-exact; eval outputs,
train-mode outputs (batch statistics; Siam's Dropout2d masks recorded from
JAX and fed to the port) and the updated running statistics
cross-framework banded in f32 on the CPU at atol 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cd_parity as cdp
from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.models.factory import CD_METHODS, PORTED_CD_METHODS
from kurosiwo_torch.models.factory import initialize_cd_model as t_init

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

METHODS = ["snunet", "siam-diff", "siam-conc", "adhr-cdnet"]
DROPOUT = {"siam-diff", "siam-conc"}


@pytest.fixture(scope="module", params=METHODS)
def run(request):
    """One method's variables, frames, and JAX's eval output, train output,
    updated batch statistics and the dropout masks it drew."""
    method = request.param
    v = cdp.variables(method)
    x1, x2 = cdp.frames(method)
    model = cdp.jax_model(method)
    ev = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False))(v, x1, x2)

    def train(v, a, b):
        return model.apply(v, a, b, train=True, mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(7)})

    with cdp.recorded_jax_masks() as masks:
        # eager where there are masks to record (they must be concrete)
        out, upd = (train if method in DROPOUT else jax.jit(train))(v, x1, x2)
    return {"method": method, "v": v, "x": (x1, x2), "eval": np.asarray(ev),
            "train": np.asarray(out), "batch_stats": cdp.tree(upd["batch_stats"]),
            "masks": list(masks)}


def _model(run):
    model = t_init(cdp.config(run["method"]), cdp.MCFG, device="cpu")
    model.load_state_dict(flax_to_torch(run["v"]))
    return model


def _x(run):
    return tuple(torch.from_numpy(a) for a in run["x"])


def test_eval_output_matches_jax(run):
    model = _model(run).eval()
    with torch.no_grad():
        y = model(*_x(run))
    assert y.dtype == torch.float32 and y.shape == run["eval"].shape
    assert y.shape == (2, cdp.SIZES[run["method"]], cdp.SIZES[run["method"]], 3)
    np.testing.assert_allclose(y.numpy(), run["eval"], atol=5e-4)


def test_train_output_and_batch_stats_match_jax(run):
    model = _model(run).train()
    assert (len(run["masks"]) == 29) == (run["method"] in DROPOUT)  # 10 + 10 + 9 Dropout2d
    with cdp.fed_masks(run["masks"]), torch.no_grad():
        y = model(*_x(run))
    np.testing.assert_allclose(y.numpy(), run["train"], atol=5e-4)
    got = torch_to_flax(model.state_dict())["batch_stats"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(run["batch_stats"])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(run["batch_stats"])):
        np.testing.assert_allclose(g, w, atol=5e-4)


def test_state_dict_names_and_shapes_match_flax_tree(run):
    method = run["method"]
    x1, x2 = (jnp.zeros(a.shape, jnp.float32) for a in run["x"])
    shapes = jax.eval_shape(lambda: cdp.jax_model(method).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x1, x2))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    want = {k: tuple(t.shape) for k, t in flax_to_torch(zeros).items()}
    got = {k: tuple(t.shape) for k, t in t_init(cdp.config(method), cdp.MCFG,
                                                device="cpu").state_dict().items()}
    assert got == want


def test_flax_torch_round_trip_is_bit_exact(run):
    v = run["v"]
    back = torch_to_flax(flax_to_torch(v))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bf16_policy_keeps_f32_params_and_f32_outputs(run):
    cfg = cdp.config(run["method"], mixed_precision=True)
    model = t_init(cfg, cdp.MCFG, device="cpu")
    model.load_state_dict(flax_to_torch(run["v"]))
    assert model.dtype == torch.bfloat16
    with torch.no_grad():
        y = model.eval()(*_x(run))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # bf16 rounds at other points than f32: a loose band on the f32 output
    assert np.abs(y.numpy() - run["eval"]).max() <= 0.25 * np.abs(run["eval"]).max()


@pytest.mark.parametrize("batch,override,want", [(64, None, True), (32, None, False),
                                                 (128, False, False), (2, True, True)],
                         ids=["b64-default", "b32-default", "off", "on"])
def test_snunet_remat_defaults_on_at_batch_64_as_jax(batch, override, want):
    cfg = cdp.config("snunet", batch=batch)
    del cfg["remat"]
    if override is not None:
        cfg["remat"] = override
    assert t_init(cfg, cdp.MCFG, device="cpu").remat is want
    assert cdp.j_init(cfg, cdp.MCFG).remat is want


@pytest.mark.parametrize("key", ["snunet_phase", "snunet_dts_up"])
def test_snunet_tpu_layout_variants_are_refused(key):
    with pytest.raises(NotImplementedError, match=rf"{key}.*Not to port"):
        t_init(cdp.config("snunet", **{key: True}), cdp.MCFG, device="cpu")


@pytest.mark.parametrize("method", CD_METHODS)
def test_attention_cd_models_name_a6(method):
    """Every change-detection method the JAX factory builds, the attention
    models of ROADMAP A6 among them (they raised naming A6 until they were
    ported), builds in the port from its shipped model config, and takes
    two frames to (B, H, W, 3) logits or ChangeFormer's list of heads."""
    small = {"snunet": cdp.MCFG, "changeformer": {"embed_dim": 16},
             "transunet-cd": {"out_channels": 8, "mlp_dim": 16, "block_num": 1}}
    mcfg = cdp.method_config(method, **small.get(method, {}))
    model = t_init(cdp.config(method, batch=1), mcfg, device="cpu").eval()
    side = cdp.SIZES[method]
    with torch.no_grad():
        out = model(torch.zeros(1, side, side, 2), torch.zeros(1, side, side, 2))
    last = out[-1] if isinstance(out, list) else out
    assert isinstance(out, list) == (method == "changeformer")
    assert tuple(last.shape) == (1, side, side, 3) and last.dtype == torch.float32


@pytest.mark.parametrize("method", METHODS + ["hfa-net", "bit-cd", "changeformer",
                                              "transunet-cd"])
def test_every_batchnorm_input_is_dense_channels_last(monkeypatch, method):
    """B3's kernel takes dense (..., C) tensors only (its wrapper raises on
    anything else on the card): every train-mode BatchNorm input of each
    model, forward and backward, is contiguous, which the CPU's plain
    version does not need and would not show."""
    from kurosiwo_torch.ops import batchnorm

    seen = []
    real = batchnorm.pair_sums_plain
    monkeypatch.setattr(batchnorm, "pair_sums_plain", lambda a, b: seen.append(
        a.is_contiguous() and b.is_contiguous()) or real(a, b))
    batch = 1 if method == "hfa-net" else 2
    mcfg = dict(cdp.MCFG, net_G="base_transformer_pos_s4", embed_dim=16, out_channels=8,
                mlp_dim=16, block_num=1)
    model = t_init(cdp.config(method, batch=batch), mcfg, device="cpu").train()
    x1, x2 = (torch.from_numpy(a) for a in cdp.frames(method, batch=batch))
    out = model(x1, x2)
    sum(o.sum() for o in out).backward() if isinstance(out, list) else out.sum().backward()
    assert seen and all(seen)


def test_every_cd_method_is_ported():
    assert PORTED_CD_METHODS == CD_METHODS and len(CD_METHODS) == 8
