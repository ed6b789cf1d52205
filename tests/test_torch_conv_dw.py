"""Port parity of B7, the 3x3 conv weight gradient
(kurosiwo_torch.ops.conv_dw) against kurosiwo_tpu.ops.pallas_dw (the Pallas
kernel in interpret mode), of ConvBNAct's ``dw_kernel`` route against the JAX
ConvBNAct under ``KUROSIWO_PALLAS_DW=interpret``, and of the routing gate
``pick_batch_block``, on the CPU (the plain versions of the port's kernels).

Bands are those of tests/test_pallas_dw.py: dW atol 2e-3 (rtol 1e-5) in
f32, 2e-2 of max |dW| with bf16 inputs; the route's gradients atol 2e-3
rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.ops import conv_dw
from kurosiwo_torch.ops.nn import ConvBNAct
from kurosiwo_tpu.ops import pallas_dw as jdw

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,cout", [((8, 14, 14, 128), 128), ((4, 28, 28, 128), 256),
                                        ((8, 12, 10, 128), 128)])
def test_conv3x3_dw_matches_jax(shape, cout):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    dy = rng.randn(*shape[:3], cout).astype(np.float32)
    want = jdw.conv3x3_dw(jnp.asarray(x), jnp.asarray(dy), batch_block=4, interpret=True)
    got = conv_dw.conv3x3_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.shape == (3, 3, shape[-1], cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-5)


def test_conv3x3_dw_bf16_matches_jax():
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(4, 14, 14, 128).astype(np.float32), dtype=jnp.bfloat16)
    dy = jnp.asarray(rng.randn(4, 14, 14, 128).astype(np.float32), dtype=jnp.bfloat16)
    want = np.asarray(jdw.conv3x3_dw(x, dy, batch_block=4, interpret=True))
    got = conv_dw.conv3x3_dw(*(torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
                               for a in (x, dy)))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 2e-2


class _Two(nn.Module):
    """Two ConvBNAct(128 -> 128) on the dW route, with the flax names of the
    JAX test's module."""

    def __init__(self, **routes):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(128, 128, **routes)
        self.ConvBNAct_1 = ConvBNAct(128, 128, **routes)

    def forward(self, x, dtype):
        return self.ConvBNAct_1(self.ConvBNAct_0(x, dtype), dtype)


def test_convbnact_dw_route_matches_jax(monkeypatch):
    """Two train-mode ConvBNAct(128) at (4, 8, 8, 128) on the B7 route against
    the JAX module with KUROSIWO_PALLAS_DW=interpret: loss, every parameter
    gradient, running statistics; the route runs the B7 function twice."""
    from kurosiwo_tpu.ops import nn as knn

    class Two(knn.nn.Module):
        @knn.nn.compact
        def __call__(self, x, train=True):
            x = knn.ConvBNAct(128, dtype=jnp.float32)(x, train=train)
            return knn.ConvBNAct(128, dtype=jnp.float32)(x, train=train)

    rng = np.random.RandomState(2)
    x = rng.randn(4, 8, 8, 128).astype(np.float32)
    monkeypatch.setenv("KUROSIWO_PALLAS_DW", "interpret")
    jm = Two()
    v = jax.tree.map(np.asarray, dict(jm.init(jax.random.PRNGKey(0), x, train=False)))

    def jloss(p):
        out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, x, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * out), upd

    (jl, jupd), jgrads = jax.value_and_grad(jloss, has_aux=True)(v["params"])

    calls = []
    real = conv_dw.conv3x3_dw
    monkeypatch.setattr(conv_dw, "conv3x3_dw", lambda *a: calls.append(1) or real(*a))
    m = _Two(dw_kernel=True)
    m.load_state_dict(flax_to_torch(v))
    m.train()
    out = m(torch.from_numpy(x), torch.float32)
    loss = (out * out).sum()
    loss.backward()
    assert len(calls) == 2
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    grads = torch_to_flax({k: p.grad for k, p in m.named_parameters()})["params"]
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(dict(jgrads))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(dict(jgrads)),
                                 jax.tree.leaves(grads)):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    stats = torch_to_flax(m.state_dict())["batch_stats"]
    for got, want in zip(jax.tree.leaves(stats), jax.tree.leaves(dict(jupd["batch_stats"]))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_dw_route_rounds_dw_to_the_compute_dtype():
    """The route hands the kernel the bf16-cast weight, as the JAX package
    does (ops/nn.py:473), so a bf16 step's dW is rounded to bf16 before it
    reaches the f32 parameter (pallas_dw.py:167): every gradient element is a
    bf16 value, within one bf16 rounding of the f32 kernel sum."""
    g = torch.Generator().manual_seed(3)
    m = ConvBNAct(128, 128, generator=g, dw_kernel=True)
    m.train()
    x = torch.randn(2, 8, 8, 128, generator=g).to(torch.bfloat16)
    calls = []
    real = conv_dw.conv3x3_dw

    def spy(a, b):
        calls.append(real(a, b))
        return calls[-1]

    conv_dw.conv3x3_dw, saved = spy, conv_dw.conv3x3_dw
    try:
        out = m(x, torch.bfloat16)
        out.float().square().sum().backward()
    finally:
        conv_dw.conv3x3_dw = saved
    grad = m.Conv_0.weight.grad
    assert grad.dtype == torch.float32 and len(calls) == 1
    assert torch.equal(grad, grad.to(torch.bfloat16).float())
    want = calls[0].permute(3, 2, 0, 1)
    assert ((grad - want).abs() <= 2.0**-8 * want.abs()).all()


def test_pick_batch_block_matches_jax():
    for b in (1, 2, 4, 6, 8, 16, 128):
        for h, w in ((7, 7), (8, 8), (14, 14), (28, 28), (12, 10), (56, 56)):
            for cin, cout in ((128, 128), (384, 128), (256, 256), (512, 512), (768, 256)):
                for itemsize in (2, 4):
                    assert conv_dw.pick_batch_block(b, h, w, cin, cout, itemsize=itemsize) == \
                        jdw.pick_batch_block(b, h, w, cin, cout, itemsize=itemsize)


def test_dw_route_gates_follow_jax():
    """The B7 gate: the B6 gate's shape rules without the 256 floor, plus
    min(H, W) >= 6 and a non-zero pick_batch_block at the call's shape."""
    m = ConvBNAct(128, 128, dw_kernel=True)
    assert m._takes_dw_route(torch.empty(128, 28, 28, 128, device="meta"), torch.bfloat16)
    assert not m._takes_dw_route(torch.zeros(2, 5, 8, 128), torch.float32)  # H < 6
    # (128, 112, 112, 128) fits no batch block of the VMEM model
    assert conv_dw.pick_batch_block(128, 112, 112, 128, 128) == 0
    assert not m._takes_dw_route(torch.empty(128, 112, 112, 128, device="meta"), torch.bfloat16)
    assert not ConvBNAct(128, 128)._takes_dw_route(torch.zeros(2, 8, 8, 128), torch.float32)
    assert not ConvBNAct(64, 64, dw_kernel=True).dw_kernel
    assert not ConvBNAct(128, 128, stride=2, dw_kernel=True).dw_kernel
