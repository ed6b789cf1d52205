"""Port parity: kurosiwo_torch.ops.batchnorm against kurosiwo_tpu.ops.pallas_bn
(the Pallas pair-sum kernel in interpret mode, and its BatchNorm module).

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernel itself is held against them on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py).

Tolerance classes: pair sums are cross-framework f32 sums of the same
values in another order (rtol 1e-5, with an absolute floor of 1e-5 times
the sum of magnitudes for sums near zero; 1e-2 for bf16 inputs, whose
products round differently); BatchNorm forward, backward and running
statistics in f32, atol 1e-5; eval mode atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.ops import batchnorm as tbn
from kurosiwo_tpu.ops import pallas_bn

torch.set_num_threads(2)


def _pair(shape, dtype, seed, same=False):
    rs = np.random.RandomState(seed)
    a = rs.randn(*shape).astype(np.float32)
    b = a if same else rs.randn(*shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return (jnp.asarray(a, jdt), jnp.asarray(b, jdt),
            torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [16, 64, 256])
def test_pair_sums_matches_pallas(c, dtype):
    ja, jb, ta, tb = _pair((2, 8, 8, c), dtype, seed=c)
    s1, s2 = pallas_bn.pair_sums(ja, jb, interpret=True)
    ours = tbn.pair_sums(ta, tb)
    assert ours.shape == (2, c) and ours.dtype == torch.float32
    rtol = 1e-5 if dtype == "f32" else 1e-2
    af, bf = ta.float().reshape(-1, c), tb.float().reshape(-1, c)
    floor1 = rtol * af.abs().sum(0).numpy()
    floor2 = rtol * (af * bf).abs().sum(0).numpy()
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(s1), rtol=rtol, atol=floor1.max())
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(s2), rtol=rtol, atol=floor2.max())


def test_pair_sums_aliased_input_is_sum_of_squares():
    _, _, ta, _ = _pair((3, 5, 5, 32), "f32", seed=1)
    s = tbn.pair_sums(ta, ta)
    np.testing.assert_allclose(s[1].numpy(), (ta.reshape(-1, 32) ** 2).sum(0).numpy(), rtol=1e-6)


# every (numel, C) the UNet-ResNet18 b128 step gives a BatchNorm, plus ragged cases
@pytest.mark.parametrize("m,c", [
    (1605632, 64), (401408, 64), (100352, 128), (25088, 256), (6272, 512),
    (1605632, 32), (6422528, 16), (9, 16), (7, 48), (5, 200), (1, 8),
])
def test_launch_geometry_covers_rows(m, c):
    rows, width, nblk, rpb = tbn.launch_geometry(m * c, c)
    assert width == 128 or width == c
    if width == 128:
        assert 128 % c == 0 and rows * 128 == m * c
    else:
        assert rows == m
    # every row in exactly one block, and no empty block
    assert nblk * rpb >= rows and (nblk - 1) * rpb < rows
    tiles = -(-width // 128)
    assert nblk * tiles <= 132 * 8 or nblk == 1


def _jax_bn(x, scale, bias, train, stats=None):
    mod = pallas_bn.BatchNorm(use_running_average=not train, interpret=True)
    v = mod.init(jax.random.PRNGKey(0), x)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": stats if stats is not None else v["batch_stats"]}
    return mod, v


def _torch_bn(scale, bias, stats=None):
    bn = tbn.BatchNorm(scale.shape[0])
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        if stats is not None:
            bn.mean.copy_(torch.from_numpy(stats["mean"]))
            bn.var.copy_(torch.from_numpy(stats["var"]))
    return bn


@pytest.mark.parametrize("c", [16, 32, 256])
def test_batchnorm_train_forward_backward_and_stats(c):
    rs = np.random.RandomState(c)
    x = (rs.randn(4, 6, 6, c) * 2 + 0.5).astype(np.float32)
    g = rs.randn(4, 6, 6, c).astype(np.float32)
    scale = (rs.rand(c) + 0.5).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    mod, v = _jax_bn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), train=True)

    def jloss(xx, p):
        y, upd = mod.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (jy, jupd)), (jdx, jdp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), v["params"])

    bn = _torch_bn(scale, bias)
    bn.train()
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = bn(tx)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(jdp["scale"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jdp["bias"]),
                               rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(jupd["batch_stats"][k]),
                                   atol=1e-5)


def test_batchnorm_eval_mode():
    rs = np.random.RandomState(5)
    c = 32
    x = rs.randn(2, 5, 5, c).astype(np.float32)
    scale = (rs.rand(c) + 0.5).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    stats = {"mean": rs.randn(c).astype(np.float32),
             "var": (rs.rand(c) + 0.1).astype(np.float32)}
    mod, v = _jax_bn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), train=False,
                     stats={k: jnp.asarray(s) for k, s in stats.items()})
    jy = mod.apply(v, jnp.asarray(x))
    bn = _torch_bn(scale, bias, stats)
    bn.eval()
    with torch.no_grad():
        ty = bn(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)


def test_batchnorm_bf16_keeps_dtype_and_f32_stats():
    bn = tbn.BatchNorm(16)
    bn.train()
    x = torch.randn(2, 4, 4, 16, generator=torch.Generator().manual_seed(0))
    y = bn(x, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert bn.mean.dtype == torch.float32 and bn.var.dtype == torch.float32
