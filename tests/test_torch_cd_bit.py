"""Port parity of BiT-CD (kurosiwo_torch/models/bit_cd.py) against
kurosiwo_tpu's, in all four ``net_G`` forms, the same weights carried
through kurosiwo_torch.convert, at 32x32 (the trunk's map 4x4 at 1/8, the
tokens' map 8x8) and batch 2, f32 on the CPU: the state_dict's names and
shapes against the flax tree and the bridge's round trip (bit-exact); eval
and train outputs and the batch statistics (atol 5e-4, ROADMAP C5); one
train step with BiT's forced SGD (momentum 0.9, decay 5e-4, lr 1e-3) and
one eval step against JAX's make_train_step and make_eval_step
(tests/test_torch_cd_steps.py's bands) for base_resnet18 and
base_transformer_pos_s4; ``..._dd8`` is s4's step with eight decoder
layers (its jitted JAX step alone takes about 26 s to trace and compile on a CPU)
and ``..._dedim8`` differs from it in the decoder's head dimension alone
(8: the einsum route, whose step ChangeFormer's stages 1 and 3 run in
tests/test_torch_cd_changeformer.py), so those two are held to JAX's in
their outputs and batch statistics. One jitted JAX run per form
(torch_cd_parity.attention_run). Then the decoder's raw, unnormalized
cross attention (the decoder_softmax=False branch) and the dilated trunk's
geometry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cd_parity as cdp
from kurosiwo_torch.models import bit_cd as tbit
from kurosiwo_torch.models.resnet import ResNetEncoder
from kurosiwo_tpu.models import bit_cd as jbit

torch.set_num_threads(2)

NET_G = ["base_resnet18", "base_transformer_pos_s4", "base_transformer_pos_s4_dd8",
         "base_transformer_pos_s4_dd8_dedim8"]
STEPS = NET_G[:2]  # the forms whose train and eval steps are held to JAX's


@functools.lru_cache(maxsize=None)
def _run(net_g: str) -> dict:
    return cdp.attention_run("bit-cd", cdp.method_config("bit-cd", net_G=net_g),
                             steps=net_g in STEPS)


@pytest.fixture(scope="module", params=NET_G)
def run(request):
    return _run(request.param)


@pytest.fixture(scope="module", params=STEPS)
def step_run(request):
    return _run(request.param)


def test_state_dict_names_and_round_trip_match_flax(run):
    cdp.check_names_and_round_trip(run)


def test_eval_and_train_outputs_and_batch_stats_match_jax(run):
    cdp.check_outputs(run)


def test_train_step_matches_jax(step_run):
    assert step_run["sgd"]  # bit-cd is forced to SGD in both packages
    cdp.check_train_step(step_run)


def test_eval_step_matches_jax(step_run):
    cdp.check_eval_step(step_run)


def test_model_per_net_g():
    want = {"base_resnet18": (tbit.BiTResNet, None, None),
            "base_transformer_pos_s4": (tbit.BiTTransformer, 1, 64),
            "base_transformer_pos_s4_dd8": (tbit.BiTTransformer, 8, 64),
            "base_transformer_pos_s4_dd8_dedim8": (tbit.BiTTransformer, 8, 8)}
    for net_g, (cls, depth, dim_head) in want.items():
        model = tbit.build_bit_cd({"net_G": net_g}, 2)
        assert type(model) is cls
        if depth is not None:
            dec = model.transformer_decoder
            assert dec.depth == depth and model.transformer.depth == 1
            assert dec.attn_0.to_q.weight.shape == (8 * dim_head, tbit.DIM)
    with pytest.raises(NotImplementedError, match="not recognized"):
        tbit.build_bit_cd({"net_G": "base_transformer_pos_s5"}, 2)


@pytest.mark.parametrize("softmax", [True, False])
def test_cross_attention_matches_jax(softmax):
    """Both branches of the decoder's cross attention (the raw branch is
    reachable only with decoder_softmax off), the scale dim ** -0.5 of the
    model width."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 20, 32).astype(np.float32)
    m = rs.randn(2, 4, 32).astype(np.float32)
    layer = jbit._CrossAttention(32, heads=8, dim_head=16, softmax=softmax)
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(m))
    want = np.asarray(layer.apply(v, jnp.asarray(x), jnp.asarray(m)))
    port = tbit._CrossAttention(32, heads=8, dim_head=16, softmax=softmax)
    p = v["params"]
    with torch.no_grad():
        for name in ("to_q", "to_k", "to_v", "to_out"):
            getattr(port, name).weight.copy_(torch.from_numpy(np.array(p[name]["kernel"]).T))
        port.to_out.bias.copy_(torch.from_numpy(np.array(p["to_out"]["bias"])))
        got = port(torch.from_numpy(x), torch.from_numpy(m), torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5 if softmax else 5e-4)


def test_dilated_trunk_geometry_matches_jax():
    """BiT's trunk (dilations (False, True, True), clamped to 1 in its
    BasicBlocks): layer3 and layer4 stay at 1/8 with undilated 3x3 convs;
    the feature list keeps JAX's indices [x, stem, layer1..layer4]."""
    enc = ResNetEncoder(2, dilations=(False, True, True), clamp_basic_dilation=True)
    feats = enc(torch.zeros(1, 32, 32, 2), torch.float32)
    assert [tuple(f.shape[1:3]) for f in feats] == [(32, 32), (16, 16), (8, 8), (4, 4), (4, 4),
                                                    (4, 4)]
    assert enc.layer3_0.ConvBNAct_0.Conv_0.stride == 1
    assert all(m.dilation == 1 for m in enc.modules() if hasattr(m, "dilation"))
    # unclamped, the stride-1 stages dilate 2 and 4 (torchvision's replace_stride_with_dilation)
    enc = ResNetEncoder(2, dilations=(False, True, True))
    assert enc.layer3_0.ConvBNAct_0.Conv_0.dilation == 2
    assert enc.layer4_1.ConvBNAct_1.Conv_0.dilation == 4 == enc.layer4_1.ConvBNAct_1.Conv_0.padding
    jfeats = jax.eval_shape(lambda: jbit.ResNetEncoder(dilations=(False, True, True))
                            .init_with_output(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2))))[0]
    assert [f.shape for f in jfeats] == [tuple(f.shape) for f in enc(torch.zeros(1, 32, 32, 2),
                                                                     torch.float32)]
