"""Port parity of B8, the small-channel 3x3 conv with a bias (+ ReLU)
epilogue (kurosiwo_torch.ops.conv_fused), against
kurosiwo_tpu.ops.pallas_conv.conv3x3_fused (the Pallas kernel in interpret
mode) at the shapes of tests/test_pallas_conv.py, on the CPU (the kernel's
plain version). Band as there: atol 1e-4 in f32; bf16 output within one
bf16 rounding of each side (2^-7 of |y|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.ops.conv_fused import conv3x3_fused
from kurosiwo_tpu.ops.pallas_conv import conv3x3_fused as j_conv3x3_fused

torch.set_num_threads(2)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,cout", [((2, 32, 16, 8), 4), ((1, 16, 17, 6), 6)])
def test_conv3x3_fused_matches_jax(shape, cout, relu):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(3, 3, shape[-1], cout).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    want = j_conv3x3_fused(*map(jnp.asarray, (x, w, b)), relu=relu, rows_per_block=8,
                           interpret=True)
    got = conv3x3_fused(*map(torch.from_numpy, (x, w, b)), relu=relu)
    assert got.dtype == torch.float32 and got.shape == (*shape[:3], cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert relu == (got.min().item() >= 0)


def test_conv3x3_fused_bf16_matches_jax():
    rs = np.random.RandomState(1)
    x = jnp.asarray(rs.randn(2, 16, 16, 16), jnp.bfloat16)
    w = jnp.asarray(rs.randn(3, 3, 16, 16) * 0.1, jnp.bfloat16)
    b = jnp.asarray(rs.randn(16), jnp.float32)
    want = np.asarray(j_conv3x3_fused(x, w, b, relu=True, rows_per_block=8, interpret=True),
                      np.float32)
    tx, tw = (torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16) for a in (x, w))
    got = conv3x3_fused(tx, tw, torch.from_numpy(np.array(b)), relu=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_less(np.abs(got.float().numpy() - want), 2.0**-7 * np.abs(want) + 1e-6)
