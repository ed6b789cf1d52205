"""Port parity: kurosiwo_torch.ops.short_attention and ops.attention against
kurosiwo_tpu.ops.pallas_attention (the short-sequence Pallas kernels in
interpret mode) and kurosiwo_tpu.ops.attention.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernel itself is held against them on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py).

Exactness class (ROADMAP C5): cross-framework banded. f32: out and lse atol
1e-5, gradients atol 1e-4 (the same f32 products summed in another order;
gradients are sums of up to Nq*D such products). bf16: both sides round p/l,
p and ds to bf16 at the same places, so the remaining differences are f32
sums in another order that move a value across a bf16 rounding boundary:
out and gradients within 1e-2 of each tensor's largest value, lse atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.ops import attention as tattn
from kurosiwo_torch.ops import short_attention as tsa
from kurosiwo_tpu.ops import attention as jattn
from kurosiwo_tpu.ops import pallas_attention as jpa

torch.set_num_threads(2)

# (B, Nq, Nk, H, D): the tiny MAE's N = 16 and its 4 kept tokens, a ragged
# N, Nq != Nk both ways, and D = 32 / 64; then the change-detection shapes
# cut to size (A6_CASES): BiT's decoder (pixels against 4 tokens) and
# ChangeFormer's reduced keys (49), each with a ragged Nq
CASES = [(2, 16, 16, 2, 64), (2, 4, 4, 2, 64), (2, 13, 13, 4, 32), (2, 9, 21, 2, 64),
         (1, 40, 7, 4, 32)]
A6_CASES = [(2, 37, 4, 2, 64), (1, 70, 49, 2, 64)]
CASES += A6_CASES


def _inputs(b, nq, nk, heads, d, seed):
    rs = np.random.RandomState(seed)
    hd = heads * d
    q = rs.randn(b, nq, hd).astype(np.float32)
    k = rs.randn(b, nk, hd).astype(np.float32)
    v = rs.randn(b, nk, hd).astype(np.float32)
    do = rs.randn(b, nq, hd).astype(np.float32)
    return q, k, v, do


def _jax_fwd_bwd(q, k, v, do, heads, scale, dtype):
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    out, lse = jpa._short_fwd_local(jq, jk, jv, heads, scale, True)
    b, n, hd = jq.shape
    delta = (jdo.astype(jnp.float32) * out.astype(jnp.float32)).reshape(b, n, heads, hd // heads)
    delta = jnp.sum(delta, axis=-1).transpose(0, 2, 1)
    grads = jpa._short_bwd_local(jq, jk, jv, jdo, lse, delta, heads, scale, True)
    f32 = lambda x: np.array(jnp.asarray(x, jnp.float32))  # writable, for torch.from_numpy
    return f32(out), f32(lse), f32(delta), [f32(g) for g in grads]


@pytest.mark.parametrize("b,nq,nk,heads,d", CASES)
def test_short_attention_fwd_bwd_match_pallas_f32(b, nq, nk, heads, d):
    q, k, v, do = _inputs(b, nq, nk, heads, d, seed=nq * 31 + nk)
    scale = d**-0.5
    out, lse, delta, grads = _jax_fwd_bwd(q, k, v, do, heads, scale, jnp.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    got_out, got_lse = tsa.short_attention_fwd(tq, tk, tv, heads, scale)
    assert got_out.shape == (b, nq, heads * d) and got_lse.shape == (b, heads, nq)
    np.testing.assert_allclose(got_out.numpy(), out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), lse, atol=1e-5, rtol=0)
    got_delta = tsa.attention_delta(tdo, got_out, heads)
    np.testing.assert_allclose(got_delta.numpy(), delta, atol=1e-5, rtol=0)
    got = tsa.short_attention_bwd(tq, tk, tv, tdo, got_lse, got_out, heads, scale)
    for g, want, name in zip(got, grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("b,nq,nk,heads,d", [CASES[0], CASES[2]])
def test_short_attention_autograd_matches_pallas_vjp(b, nq, nk, heads, d):
    """The custom VJP end to end: q, k, v as the column-thirds of one qkv
    tensor (strided views, as SelfAttention passes them)."""
    q, k, v, do = _inputs(b, nq, nk, heads, d, seed=7)
    _, _, _, grads = _jax_fwd_bwd(q, k, v, do, heads, d**-0.5, jnp.float32)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_(True)
    tq, tk, tv = qkv.chunk(3, dim=-1)
    assert tq.stride() == (nq * 3 * heads * d, 3 * heads * d, 1)
    out = tsa.short_attention(tq, tk, tv, heads)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(qkv.grad.numpy(), np.concatenate(grads, -1), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,nq,nk,heads,d", [CASES[0], CASES[2], CASES[4]] + A6_CASES)
def test_short_attention_bf16_matches_pallas(b, nq, nk, heads, d):
    q, k, v, do = _inputs(b, nq, nk, heads, d, seed=11)
    scale = d**-0.5
    out, lse, delta, grads = _jax_fwd_bwd(q, k, v, do, heads, scale, jnp.bfloat16)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    got_out, got_lse = tsa.short_attention_fwd(tq, tk, tv, heads, scale)
    assert got_out.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_out.float().numpy(), out, atol=1e-2 * np.abs(out).max())
    np.testing.assert_allclose(got_lse.numpy(), lse, atol=1e-4, rtol=0)
    # JAX's delta is sum_d(do * out) of its own bf16 out: hand the wrapper that out
    jout = torch.from_numpy(out).to(torch.bfloat16)
    np.testing.assert_allclose(tsa.attention_delta(tdo, jout, heads).numpy(), delta, atol=1e-5,
                               rtol=0)  # the same f32 products, summed in another order
    got = tsa.short_attention_bwd(tq, tk, tv, tdo, got_lse, jout, heads, scale)
    for g, want, name in zip(got, grads, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), want, atol=1e-2 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("b,nq,nk,heads,d", A6_CASES)
def test_short_attention_on_kv_halves_matches_pallas_vjp(b, nq, nk, heads, d):
    """_ShortAttention on separate q and the two column halves of one kv
    projection (strided views, as ChangeFormer's efficient attention passes
    them): out, dq and the kv gradient (autograd assembles it from dk and
    dv) against JAX's custom-VJP short attention, f32 on the CPU."""
    q, k, v, do = _inputs(b, nq, nk, heads, d, seed=nq + 5 * nk)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    fn = lambda a, b_, c: jpa.short_attention(a, b_, c, heads, None, True)
    want_out, vjp = jax.vjp(fn, jq, jk, jv)
    dq, dk, dv = (np.asarray(g) for g in vjp(jdo))
    tq = torch.from_numpy(q).requires_grad_(True)
    kv = torch.from_numpy(np.concatenate([k, v], -1)).requires_grad_(True)
    tk, tv = kv.chunk(2, dim=-1)
    assert tk.stride() == (nk * 2 * heads * d, 2 * heads * d, 1) and not tv.is_contiguous()
    out = tattn.attention_packed(tq, tk, tv, heads)
    assert "ShortAttention" in type(out.grad_fn).__name__
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(tq.grad.numpy(), dq, atol=1e-4, rtol=0)
    np.testing.assert_allclose(kv.grad.numpy(), np.concatenate([dk, dv], -1), atol=1e-4, rtol=0)


def _grad_views(b, nq, nk, hd):
    """dq, dk, dv as views the wrapper writes into: the column-thirds of one
    (B, N, 3*H*D) qkv gradient where Nq == Nk, else strided views of wider
    buffers."""
    if nq == nk:
        buf = torch.full((b, nq, 3 * hd), float("nan"))
        return buf, buf.chunk(3, dim=-1)
    bq, bk = torch.full((b, nq, 2 * hd), float("nan")), torch.full((b, nk, 3 * hd), float("nan"))
    return None, (bq[..., hd:], bk[..., :hd], bk[..., 2 * hd:])


@pytest.mark.parametrize("b,nq,nk,heads,d", CASES)
def test_short_attention_bwd_from_out_into_views_matches_pallas(b, nq, nk, heads, d):
    """The backward wrapper takes the forward's out (delta is computed from
    it) and writes dq, dk and dv into the caller's views, against
    _short_bwd_local in interpret mode fed JAX's own delta."""
    q, k, v, do = _inputs(b, nq, nk, heads, d, seed=3 * nq + nk)
    scale = d**-0.5
    out, lse, _, grads = _jax_fwd_bwd(q, k, v, do, heads, scale, jnp.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    buf, views = _grad_views(b, nq, nk, heads * d)
    got = tsa.short_attention_bwd(tq, tk, tv, tdo, torch.from_numpy(lse), torch.from_numpy(out),
                                  heads, scale, *views)
    for g, view, want, name in zip(got, views, grads, ("dq", "dk", "dv")):
        assert g is view
        np.testing.assert_allclose(view.numpy(), want, atol=1e-4, rtol=0, err_msg=name)
    if buf is not None:
        np.testing.assert_allclose(buf.numpy(), np.concatenate(grads, -1), atol=1e-4, rtol=0)


def _jax_qkv_vjp(q, k, v, do, heads):
    """JAX's custom-VJP short attention (Pallas kernels in interpret mode):
    out and the concatenation of its dq, dk, dv."""
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    fn = lambda a, b_, c: jpa.short_attention(a, b_, c, heads, None, True)
    out, vjp = jax.vjp(fn, jq, jk, jv)
    return np.asarray(out), np.concatenate([np.asarray(g) for g in vjp(jdo)], -1)


@pytest.mark.parametrize("b,nq,nk,heads,d", [c for c in CASES if c[1] == c[2]])
def test_short_attention_qkv_matches_pallas_vjp(b, nq, nk, heads, d):
    """short_attention_qkv on the packed projection: out and its dqkv (the
    three gradients written into the thirds of one tensor) against the
    concatenation of JAX's custom-VJP dq, dk, dv, f32 on the CPU."""
    q, k, v, do = _inputs(b, nq, nk, heads, d, seed=5 * nq + d)
    want_out, want_dqkv = _jax_qkv_vjp(q, k, v, do, heads)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_(True)
    out = tsa.short_attention_qkv(qkv, heads)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5, rtol=0)
    out.backward(torch.from_numpy(do))
    assert qkv.grad.shape == qkv.shape and qkv.grad.is_contiguous()
    np.testing.assert_allclose(qkv.grad.numpy(), want_dqkv, atol=1e-4, rtol=0)


def test_attention_qkv_routes_by_shape(monkeypatch):
    """attention_qkv sends short-route shapes to short_attention_qkv (one
    autograd node on the whole projection) and the others through the
    thirds, as attention_packed does."""
    calls = []
    real = tattn.short_attention_qkv
    monkeypatch.setattr(tattn, "short_attention_qkv", lambda *a: calls.append(1) or real(*a))
    rs = np.random.RandomState(1)
    for n, heads, d, short in ((16, 2, 64, True), (16, 3, 16, False)):
        x = rs.randn(2, n, 3 * heads * d).astype(np.float32)
        qkv = torch.from_numpy(x).requires_grad_(True)
        out = tattn.attention_qkv(qkv, heads)
        want = tattn.attention_packed(*torch.from_numpy(x).chunk(3, dim=-1), heads)
        np.testing.assert_allclose(out.detach().numpy(), want.numpy(), atol=1e-6, rtol=0)
        assert ("ShortAttentionQKV" in type(out.grad_fn).__name__) == short
    assert len(calls) == 1


@pytest.mark.parametrize("n,heads,d", [(16, 2, 64), (16, 3, 16), (10, 2, 48), (49, 16, 64)])
def test_attention_packed_matches_jax(n, heads, d):
    """Routing: D in {32, 64, 128} with H*D % 128 == 0 takes the short
    kernel (plain version here), anything else the einsum path; both give
    the JAX package's function (its CPU path is the einsum)."""
    q, k, v, _ = _inputs(2, n, n, heads, d, seed=n + d)
    want = np.asarray(jattn.attention_packed(*(jnp.asarray(x) for x in (q, k, v)), heads))
    got = tattn.attention_packed(*(torch.from_numpy(x) for x in (q, k, v)), heads)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_attention_bhnd_matches_jax():
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(2, 3, 12, 16).astype(np.float32) for _ in range(3))
    want = np.asarray(jattn.attention(*(jnp.asarray(x) for x in (q, k, v))))
    got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_flash_route_shapes_run_the_flash_kernel_wrapper(monkeypatch):
    """Flash-route shapes go to the flash attention of ROADMAP B5
    (``ops/flash_attention.py``), never to the short kernel: both entry
    points reach its forward wrapper, whose plain version runs here."""
    from kurosiwo_torch.ops import flash_attention as tfa

    calls = []
    fwd = tfa.flash_attention_fwd
    monkeypatch.setattr(tfa, "flash_attention_fwd", lambda *a: calls.append(1) or fwd(*a))
    monkeypatch.setattr(tattn, "short_attention", None)
    q = torch.zeros(1, 1024, 128)
    assert tattn.attention_packed(q, q, q, 2).shape == (1, 1024, 128)
    qh = q.reshape(1, 1024, 2, 64).transpose(1, 2)
    assert tattn.attention(qh, qh, qh).shape == (1, 2, 1024, 64)
    assert len(calls) == 2


@pytest.mark.parametrize("n", [49, 128, 196, 1024, 3136, 4096, 1000, 384])
def test_pick_block_matches_jax(n):
    for want in (256, 1024):
        assert tattn._pick_block(n, want) == jattn._pick_block(n, want)


def test_changeformer_sequence_goes_to_the_short_kernel():
    """N = 3136 has no 128-multiple block, so the router sends it to the
    short kernel, as on the TPU."""
    assert not tattn._flash_route(3136, 3136)
    assert tattn._flash_route(4096, 4096)


@pytest.mark.parametrize("shape,heads,err", [
    ((2, 8, 96), 2, ValueError),      # D = 48
    ((2, 8, 64), 2, ValueError),      # H*D = 64, not a multiple of 128
    ((2, 8, 128), 3, ValueError),     # H does not divide H*D
])
def test_kernel_wrappers_reject_what_the_kernel_does_not_take(shape, heads, err):
    x = torch.zeros(shape)
    with pytest.raises(err):
        tsa.short_attention_fwd(x, x, x, heads, 1.0)
