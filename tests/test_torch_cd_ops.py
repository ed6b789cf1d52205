"""The change-detection building blocks of kurosiwo_torch.ops.nn (and
HFA-Net's high-pass bank and PReLU) against kurosiwo_tpu's, with the same
parameters carried through kurosiwo_torch.convert; the deterministic
resampling forms against torch's library ops; the BatchNorm and Dropout2d
remat modes (kurosiwo_torch.ops.remat).

Exactness classes (ROADMAP C5): cross-framework f32 on the CPU at atol 5e-4
(the convolutions), 1e-5 for the pools, the resize and the pad (no
reduction longer than two taps); the pad and the remat replay bit-exact
within torch; the resize against ``F.interpolate`` at atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kurosiwo_torch.convert import torch_to_flax
from kurosiwo_torch.models import hfanet as t_hfanet
from kurosiwo_torch.ops import batchnorm as t_bn
from kurosiwo_torch.ops import nn as tnn
from kurosiwo_torch.ops.remat import remat
from kurosiwo_tpu.models import hfanet as j_hfanet
from kurosiwo_tpu.ops import nn as jnn

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _params(module: torch.nn.Module) -> dict:
    return torch_to_flax(module.state_dict())["params"]


@pytest.mark.parametrize("cin,cout,k,s,p,op,hw", [
    (6, 5, 3, 1, 1, 0, (9, 7)),   # Siam's decoder convs
    (6, 5, 3, 2, 1, 1, (9, 7)),   # Siam's and HFA-Net's 2x upconvs
    (8, 4, 3, 3, 2, 2, (3, 3)),   # HFA-Net's last-layer spatial attention
    (4, 4, 2, 2, 0, 0, (5, 6)),   # ConvTranspose2x's geometry
], ids=["k3s1p1", "k3s2p1op1", "k3s3p2op2", "k2s2"])
def test_torch_conv_transpose_matches_jax(cin, cout, k, s, p, op, hw):
    """The bridge's generic 4-D rule maps the flax (k, k, O, I) kernel to
    (I, O, k, k), F.conv_transpose2d's layout: the same function."""
    g = torch.Generator().manual_seed(1)
    mod = tnn.TorchConvTranspose(cin, cout, k, s, p, op, generator=g)
    mod.bias.data.normal_(generator=g)
    x = _x((2, *hw, cin))
    want = jnn.TorchConvTranspose(cout, k, s, p, op).apply({"params": _params(mod)},
                                                           jnp.asarray(x))
    got = mod(torch.from_numpy(x), torch.float32)
    assert got.shape == want.shape == (2, (hw[0] - 1) * s - 2 * p + k + op,
                                       (hw[1] - 1) * s - 2 * p + k + op, cout)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-4)


@pytest.mark.parametrize("via_phase", [True, False], ids=["phase", "dilated"])
def test_conv_transpose_2x_matches_both_jax_forms(via_phase):
    g = torch.Generator().manual_seed(2)
    mod = tnn.ConvTranspose2x(6, 6, generator=g)
    mod.up.bias.data.normal_(generator=g)
    x = _x((2, 5, 4, 6))
    want = jnn.ConvTranspose2x(6, via_phase=via_phase).apply({"params": _params(mod)},
                                                           jnp.asarray(x))
    got = mod(torch.from_numpy(x), torch.float32)
    assert set(mod.state_dict()) == {"up.weight", "up.bias"}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-4)


def test_channel_attention_matches_jax():
    mod = tnn.ChannelAttention(32, ratio=4, generator=torch.Generator().manual_seed(3))
    x = _x((2, 6, 5, 32))
    want = jnn.ChannelAttention(ratio=4).apply({"params": _params(mod)}, jnp.asarray(x))
    got = mod(torch.from_numpy(x), torch.float32)
    assert got.shape == (2, 1, 1, 32) and mod.fc1.bias is None and mod.fc2.bias is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-4)


def test_global_pools_match_jax():
    x = _x((3, 5, 7, 4))
    for t, j in ((tnn.global_avg_pool, jnn.global_avg_pool), (tnn.global_max_pool,
                                                              jnn.global_max_pool)):
        np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(), np.asarray(j(jnp.asarray(x))),
                                   atol=1e-5)


@pytest.mark.parametrize("target", [(7, 9), (5, 9), (7, 6), (5, 6)],
                         ids=["both", "width", "height", "none"])
def test_replication_pad_matches_jax_and_the_library_pad(target):
    x = _x((2, 5, 6, 3))
    got = tnn.replication_pad_to(torch.from_numpy(x), *target)
    want = jnn.replication_pad_to(jnp.asarray(x), *target)
    lib = F.pad(torch.from_numpy(x).permute(0, 3, 1, 2), (0, target[1] - 6, 0, target[0] - 5),
                mode="replicate").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, lib)


def test_replication_pad_gradient_matches_the_library_pad():
    x = torch.from_numpy(_x((2, 5, 6, 3))).requires_grad_()
    dy = torch.from_numpy(_x((2, 8, 9, 3), seed=1))
    (gx,) = torch.autograd.grad((tnn.replication_pad_to(x, 8, 9) * dy).sum(), x)
    lib = F.pad(x.permute(0, 3, 1, 2), (0, 3, 0, 3), mode="replicate").permute(0, 2, 3, 1)
    (want,) = torch.autograd.grad((lib * dy).sum(), x)
    np.testing.assert_allclose(gx.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True], ids=["half-pixel", "corners"])
@pytest.mark.parametrize("hw,size", [((7, 5), (14, 10)), ((4, 3), (32, 24)), ((6, 6), (13, 9))],
                         ids=["x2", "x8", "ragged"])
def test_resize_bilinear_matches_jax_and_interpolate(align_corners, hw, size):
    """Upsampling, as HFA-Net (corner-aligned x2) and ADHR (half-pixel x2,
    x4, x8) use it; C8's antialiasing arises only when jax.image.resize
    downsamples, which the port refuses."""
    x = _x((2, *hw, 3))
    got = tnn.resize_bilinear(torch.from_numpy(x), size, align_corners)
    want = jnn.resize_bilinear(jnp.asarray(x), size, align_corners)
    lib = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=size, mode="bilinear",
                        align_corners=align_corners).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), atol=1e-6)


def test_resize_bilinear_gradient_matches_interpolate():
    x = torch.from_numpy(_x((2, 7, 5, 3))).requires_grad_()
    dy = torch.from_numpy(_x((2, 14, 10, 3), seed=1))
    for ac in (False, True):
        (got,) = torch.autograd.grad((tnn.resize_bilinear(x, (14, 10), ac) * dy).sum(), x)
        lib = F.interpolate(x.permute(0, 3, 1, 2), size=(14, 10), mode="bilinear",
                            align_corners=ac).permute(0, 2, 3, 1)
        (want,) = torch.autograd.grad((lib * dy).sum(), x)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_resize_bilinear_refuses_to_downsample():
    with pytest.raises(NotImplementedError, match="antialias"):
        tnn.resize_bilinear(torch.zeros(1, 8, 8, 1), (4, 4))


def test_resize_bilinear_keeps_bf16():
    y = tnn.resize_bilinear(torch.zeros(1, 4, 4, 2, dtype=torch.bfloat16), (8, 8), True)
    assert y.dtype == torch.bfloat16


def test_dropout2d_draws_channel_masks_from_its_generator():
    do = tnn.Dropout2d(0.2).train()
    x = torch.ones(64, 3, 3, 32)
    a = do(x, torch.Generator().manual_seed(0))
    b = do(x, torch.Generator().manual_seed(0))
    c = do(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # whole maps: every pixel of a (sample, channel) is kept or dropped together
    kept = a[:, 0, 0, :] != 0
    assert torch.equal((a != 0), kept[:, None, None, :].expand_as(a))
    np.testing.assert_allclose(a[a != 0].numpy(), 1.25)
    assert abs(kept.float().mean().item() - 0.8) < 0.03
    assert torch.equal(do.eval()(x), x)


def test_dropout2d_applies_the_mask_as_jax():
    """JAX's Dropout2d draws from make_rng("dropout"), which the port cannot
    replay (as C15); given JAX's mask, the port computes JAX's output."""
    x = _x((2, 4, 4, 6))
    rng = jax.random.PRNGKey(3)
    want = jnn.Dropout2d(0.2).apply({}, jnp.asarray(x), deterministic=False,
                                    rngs={"dropout": rng})
    mask = np.asarray(want).any(axis=(1, 2), keepdims=True)  # x has no zero
    do = tnn.Dropout2d(0.2).train()
    do.draw_mask = lambda x, g: torch.from_numpy(mask)
    np.testing.assert_allclose(do(torch.from_numpy(x)).numpy(), np.asarray(want), atol=1e-6)


def test_prelu_matches_jax():
    mod = t_hfanet.PReLU(5)
    mod.alpha.data = torch.linspace(-0.5, 0.5, 5)
    x = _x((2, 3, 3, 5))
    want = j_hfanet.PReLU().apply({"params": _params(mod)}, jnp.asarray(x))
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               atol=1e-6)


@pytest.mark.parametrize("mode,smooth", [("filtering", True), ("high_boost_filtering", True),
                                         ("high_boost_filtering", False)])
def test_high_frequency_matches_jax(mode, smooth):
    x = _x((2, 9, 7, 4))
    got = t_hfanet.high_frequency(torch.from_numpy(x), mode=mode, smooth=smooth)
    want = j_hfanet.high_frequency(jnp.asarray(x), mode=mode, smooth=smooth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)


def test_batchnorm_replays_its_statistics_in_a_remat_region(monkeypatch):
    """The recompute of a region normalizes with the statistics the first
    forward reduced: no second pair-sum and no second running update, and
    the same output and gradients as without remat, bitwise."""
    calls = []
    real = t_bn.pair_sums
    monkeypatch.setattr(t_bn, "pair_sums", lambda a, b: calls.append(1) or real(a, b))
    x0 = torch.from_numpy(_x((4, 5, 5, 8)))
    out = {}
    for use_remat, save in ((False, True), (True, True), (True, False)):
        bn = t_bn.BatchNorm(8).train()
        x = x0.clone().requires_grad_()
        calls.clear()
        fn = lambda t: torch.relu(bn(t)) * 2.0  # noqa: E731
        y = remat(fn, x, save_bn_stats=save) if use_remat else fn(x)
        fwd = len(calls)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        out[(use_remat, save)] = (y.detach(), x.grad, bn.mean.clone(), bn.var.clone(), fwd,
                                  len(calls))
    base = out[(False, True)]
    for key in ((True, True), (True, False)):
        got = out[key]
        for a, b in zip(got[:4], base[:4]):
            assert torch.equal(a, b)
    assert base[4:] == (1, 2) and out[(True, True)][4:] == (1, 2)
    assert out[(True, False)][4:] == (1, 3)  # JAX's policy without saved statistics


def test_remat_region_replays_the_dropout_masks():
    do = tnn.Dropout2d(0.5).train()
    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_x((8, 3, 3, 16))).requires_grad_()
    y = remat(lambda t: do(t, g) * t, x)
    (gx,) = torch.autograd.grad(y.sum(), x)
    # d(mask * t / keep * t)/dt = 2 t mask / keep, with the forward's mask
    np.testing.assert_allclose(gx.numpy(), (2 * y / x).detach().numpy(), atol=1e-5)
