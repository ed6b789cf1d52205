"""Port parity of B6, the 3x3 conv with its BatchNorm statistics
(kurosiwo_torch.ops.conv_bn) against kurosiwo_tpu.ops.pallas_conv_bn (the
Pallas kernel in interpret mode), and of ConvBNAct's ``conv_bn_kernel`` route
against the JAX ConvBNAct under ``KUROSIWO_PALLAS_CONV=interpret``, on the
CPU (the plain versions of the port's kernels).

Bands are those of tests/test_pallas_conv_bn.py: cross-framework f32 sums in
another order. y atol 2e-4, statistics rtol 5e-4 (atol 1e-3); the custom
VJP's out 1e-4, mean 1e-5, var 1e-4 and gradients atol 5e-3 rtol 1e-3; the
route's output 1e-4, running statistics 1e-3 and gradients atol 5e-2 rtol
2e-3. bf16 y within one bf16 rounding of each side (2^-7 of |y|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.ops import conv_bn
from kurosiwo_torch.ops.nn import ConvBNAct
from kurosiwo_tpu.ops import pallas_conv_bn as jcb

torch.set_num_threads(2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("shape,cout", [((2, 16, 28, 128), 128), ((1, 8, 14, 256), 128)])
def test_conv3x3_bn_stats_matches_jax(shape, cout, prologue):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(3, 3, shape[-1], cout) * 0.05).astype(np.float32)
    sb = ()
    if prologue:
        sb = ((rs.rand(shape[-1]) + 0.5).astype(np.float32),
              (rs.randn(shape[-1]) * 0.1).astype(np.float32))
    jy, jst = jcb.conv3x3_bn_stats(jnp.asarray(x), jnp.asarray(w), *map(jnp.asarray, sb),
                                   rows_per_block=8, interpret=True)
    y, st = conv_bn.conv3x3_bn_stats(_t(x), _t(w), *map(_t, sb))
    assert y.dtype == torch.float32 and st.shape == (2, cout)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=5e-4, atol=1e-3)


def test_conv3x3_bn_stats_bf16_matches_jax():
    rs = np.random.RandomState(2)
    x = jnp.asarray(rs.randn(1, 16, 28, 128), jnp.bfloat16)
    w = jnp.asarray(rs.randn(3, 3, 128, 128) * 0.05, jnp.bfloat16)
    jy, jst = jcb.conv3x3_bn_stats(x, w, rows_per_block=8, interpret=True)
    y, st = conv_bn.conv3x3_bn_stats(_t(x.astype(jnp.float32), torch.bfloat16),
                                     _t(w.astype(jnp.float32), torch.bfloat16))
    assert y.dtype == torch.bfloat16
    want = np.asarray(jy, np.float32)
    np.testing.assert_array_less(np.abs(y.float().numpy() - want), 2.0**-7 * np.abs(want) + 1e-6)
    # the statistics come from the f32 accumulator on both sides
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=5e-4, atol=1e-3)


def test_conv3x3_bn_vjp_matches_jax():
    """conv3x3_bn (the kernel's forward, the custom backward) against the
    JAX custom VJP: out, mean, var and the four gradients."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 6, 128).astype(np.float32)
    w = (rng.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
    scale = (rng.rand(128) + 0.5).astype(np.float32)
    bias = (rng.randn(128) * 0.1).astype(np.float32)

    def jloss(*a):
        out, _, _ = jcb.conv3x3_bn(*a, 1e-5, True)
        return jnp.sum(out * jnp.cos(out))

    jout, jmean, jvar = jcb.conv3x3_bn(*map(jnp.asarray, (x, w, scale, bias)), 1e-5, True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, w, scale, bias)))
    args = [_t(a).requires_grad_(True) for a in (x, w, scale, bias)]
    out, mean, var = conv_bn.conv3x3_bn(*args)
    (out * torch.cos(out)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-4)
    for got, want, name in zip(args, jgrads, ["dx", "dw", "dgamma", "dbeta"]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=5e-3, rtol=1e-3,
                                   err_msg=name)


def test_convbnact_conv_bn_route_matches_jax(monkeypatch):
    """ConvBNAct(256 -> 256) in train mode on the B6 route against the JAX
    ConvBNAct with KUROSIWO_PALLAS_CONV=interpret, from the same variables:
    output, running statistics and parameter gradients; the route runs the
    B6 function once."""
    from kurosiwo_tpu.ops.nn import ConvBNAct as JConvBNAct

    rng = np.random.RandomState(11)
    x = (rng.randn(2, 8, 8, 256) * 0.5).astype(np.float32)
    mod = JConvBNAct(256, 3, 1)
    monkeypatch.setenv("KUROSIWO_PALLAS_CONV", "interpret")
    variables = jax.tree.map(np.asarray, dict(mod.init(jax.random.PRNGKey(0), x, False)))

    def jloss(p):
        out, upd = mod.apply({**variables, "params": p}, x, True, mutable=["batch_stats"])
        return jnp.sum(out**2), (out, upd)

    (_, (jout, jupd)), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])

    calls = []
    real = conv_bn.conv3x3_bn_stats
    monkeypatch.setattr(conv_bn, "conv3x3_bn_stats", lambda *a: calls.append(1) or real(*a))
    m = ConvBNAct(256, 256, conv_bn_kernel=True)
    m.load_state_dict(flax_to_torch(variables))
    m.train()
    out = m(torch.from_numpy(x), torch.float32)
    (out**2).sum().backward()
    assert len(calls) == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-4)
    stats = torch_to_flax(m.state_dict())["batch_stats"]
    for got, want in zip(jax.tree.leaves(stats), jax.tree.leaves(dict(jupd["batch_stats"]))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-3, rtol=1e-3)
    grads = torch_to_flax({k: p.grad for k, p in m.named_parameters()})["params"]
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(dict(jgrads))
    for got, want in zip(jax.tree.leaves(grads), jax.tree.leaves(dict(jgrads))):
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-2, rtol=2e-3)


def test_conv_bn_route_gates_follow_jax():
    """The B6 gate: train-mode 3x3 stride-1 default-padding convs with
    128-multiple channels and min(Cin, Cout) >= 256."""
    assert ConvBNAct(256, 256, conv_bn_kernel=True).conv_bn_kernel
    assert ConvBNAct(768, 256, conv_bn_kernel=True).conv_bn_kernel
    assert not ConvBNAct(256, 256).conv_bn_kernel  # off by default
    assert not ConvBNAct(128, 256, conv_bn_kernel=True).conv_bn_kernel
    assert not ConvBNAct(256, 256, stride=2, conv_bn_kernel=True).conv_bn_kernel
    assert not ConvBNAct(256, 256, kernel=1, padding=0, conv_bn_kernel=True).conv_bn_kernel
    assert not ConvBNAct(256, 256, padding=1, conv_bn_kernel=True).conv_bn_kernel
    assert not ConvBNAct(320, 320, conv_bn_kernel=True).conv_bn_kernel
