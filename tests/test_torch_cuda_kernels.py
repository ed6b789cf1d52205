"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is available (the
decision is made inside the fixture, never at import). On a machine with
the card (which has no JAX, so the repository conftest is skipped):
``python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest``.
chip_smoke.py runs the same comparisons at the main path's full shapes.
"""

import pytest
import torch

from kurosiwo_torch.ops import batchnorm, fused_tail
from kurosiwo_torch.ops import short_attention as sa

pytestmark = pytest.mark.cuda

CW = [0.3715753140309927, 14.009780283125977, 8.20405370357821]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (4, 8, 8, 64), (2, 7, 7, 512), (3, 5, 5, 48),
                                   (1, 3, 3, 200)])
def test_pair_sums_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(shape, device=dev, generator=g).to(dtype)
    b = torch.randn(shape, device=dev, generator=g).to(dtype)
    n0 = batchnorm.pair_sums.launches
    for x, y in ((a, b), (a, a)):
        got = batchnorm.pair_sums(x, y)
        want = batchnorm.pair_sums_plain(x, y)
        c = shape[-1]
        scale = torch.stack([x.float().reshape(-1, c).abs().sum(0),
                             (x.float() * y.float()).reshape(-1, c).abs().sum(0)])
        assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
        assert torch.equal(got, batchnorm.pair_sums(x, y))  # deterministic
    assert batchnorm.pair_sums.launches == n0 + 4


@pytest.mark.parametrize("layout", ["nhwc", "phase"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_cm_kernels_match_plain(dev, layout, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    b, h, w = 3, 18, 22
    shape = (b, h, w, 3) if layout == "nhwc" else (b, h // 2, w // 2, 12)
    logits = torch.randn(shape, device=dev, generator=g).to(dtype)
    labels = torch.randint(0, 4, (b, h, w), device=dev, generator=g, dtype=torch.int32)
    cw = torch.tensor(CW, device=dev)
    fwd = fused_tail.ce_cm_fwd_nhwc if layout == "nhwc" else fused_tail.ce_cm_fwd_phase
    bwd = fused_tail.ce_cm_bwd_nhwc if layout == "nhwc" else fused_tail.ce_cm_bwd_phase
    plain_f = (fused_tail.ce_cm_forward_plain if layout == "nhwc"
               else fused_tail.ce_cm_phase_forward_plain)
    plain_b = (fused_tail.ce_cm_backward_plain if layout == "nhwc"
               else fused_tail.ce_cm_phase_backward_plain)
    loss, cm, tw = fwd(logits, labels, cw)
    rl, rcm, rtw = plain_f(logits, labels, cw)
    torch.testing.assert_close(loss, rl, rtol=1e-5, atol=0)
    torch.testing.assert_close(tw, rtw, rtol=1e-5, atol=0)
    assert torch.equal(cm, rcm)
    gs = (1.0 / tw).reshape(1)
    d = bwd(logits, labels, cw, gs)
    rd = plain_b(logits, labels, cw, gs)
    assert d.dtype == dtype and d.shape == logits.shape
    tol = (1e-5 if dtype == torch.float32 else 1e-2) * rd.float().abs().max()
    assert (d.float() - rd.float()).abs().max() <= tol
    assert torch.equal(d, bwd(logits, labels, cw, gs))


def test_fused_ce_cm_autograd_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    logits = torch.randn(2, 16, 16, 3, device=dev, generator=g, requires_grad=True)
    labels = torch.randint(0, 4, (2, 16, 16), device=dev, generator=g, dtype=torch.int32)
    loss, cm = fused_tail.fused_ce_cm(logits, labels, CW)
    (2.0 * loss).backward()
    ref = logits.detach().cpu().requires_grad_(True)
    rl, rcm = fused_tail.fused_ce_cm(ref, labels.cpu(), CW)
    (2.0 * rl).backward()
    torch.testing.assert_close(loss.cpu(), rl, rtol=1e-5, atol=0)
    assert torch.equal(cm.cpu(), rcm)
    torch.testing.assert_close(logits.grad.cpu(), ref.grad, rtol=0, atol=1e-6)


def test_kernel_wrappers_raise_on_layouts_they_do_not_take(dev):
    x = torch.randn(2, 4, 4, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        batchnorm.pair_sums(x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(TypeError):
        batchnorm.pair_sums(x, x.to(torch.bfloat16))


def _attention_inputs(dev, b, nq, nk, heads, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    hd = heads * d
    q, do = (torch.randn(b, nq, hd, device=dev, generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, nk, hd, device=dev, generator=g).to(dtype) for _ in range(2))
    return q, k, v, do


def _close(got, want, band):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= band * want.float().abs().max().item(), (err, band)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,heads,d", [(3, 49, 49, 4, 64), (2, 77, 77, 8, 32),
                                             (2, 130, 20, 2, 64), (1, 5, 200, 1, 128),
                                             (2, 196, 196, 16, 64)])
def test_short_attention_kernel_matches_plain(dev, b, nq, nk, heads, d, dtype):
    """Bands as chip_smoke.py: f32 out and lse 1e-5, grads 1e-4 of each
    tensor's largest value (f32 sums in another order, online softmax);
    bf16 out 1e-2, lse 1e-3, grads 2e-2 (the kernel keeps p unrounded in
    the forward; one bf16 rounding of p and ds in both backwards)."""
    q, k, v, do = _attention_inputs(dev, b, nq, nk, heads, d, dtype, seed=nq + nk)
    scale = d**-0.5
    f32 = dtype == torch.float32
    n0 = sa.short_attention_fwd.launches, sa.short_attention_bwd.launches
    out, lse = sa.short_attention_fwd(q, k, v, heads, scale)
    want_out, want_lse = sa.short_attention_fwd_plain(q, k, v, heads, scale)
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (b, heads, nq)
    _close(out, want_out, 1e-5 if f32 else 1e-2)
    assert (lse - want_lse).abs().max().item() <= (1e-5 * want_lse.abs().max().item() if f32
                                                   else 1e-3)
    delta = sa.attention_delta(do, want_out, heads)
    got = sa.short_attention_bwd(q, k, v, do, want_lse, delta, heads, scale)
    want = sa.short_attention_bwd_plain(q, k, v, do, want_lse, delta, heads, scale)
    for g_, w_ in zip(got, want):
        assert g_.dtype == dtype
        _close(g_, w_, 1e-4 if f32 else 2e-2)
    again = sa.short_attention_bwd(q, k, v, do, want_lse, delta, heads, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # deterministic
    assert torch.equal(out, sa.short_attention_fwd(q, k, v, heads, scale)[0])
    assert (sa.short_attention_fwd.launches, sa.short_attention_bwd.launches) == (n0[0] + 2,
                                                                                 n0[1] + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_attention_autograd_on_the_card(dev, dtype):
    """A qkv split (strided views) through the custom VJP, card against CPU
    (bands as above, relative to each tensor's largest value)."""
    g = torch.Generator(device=dev).manual_seed(4)
    b, n, heads, d = 2, 50, 2, 64
    qkv = torch.randn(b, n, 3 * heads * d, device=dev, generator=g).to(dtype).requires_grad_(True)
    do = torch.randn(b, n, heads * d, device=dev, generator=g).to(dtype)
    out = sa.short_attention(*qkv.chunk(3, dim=-1), heads)
    out.backward(do)
    ref = qkv.detach().cpu().requires_grad_(True)
    rout = sa.short_attention(*ref.chunk(3, dim=-1), heads)
    rout.backward(do.cpu())
    f32 = dtype == torch.float32
    _close(out.detach().cpu(), rout.detach(), 1e-5 if f32 else 1e-2)
    _close(qkv.grad.cpu(), ref.grad, 1e-4 if f32 else 2e-2)


def test_short_attention_wrappers_raise_on_layouts_they_do_not_take(dev):
    x = torch.randn(2, 8, 128, device=dev)
    with pytest.raises(TypeError):
        sa.short_attention_fwd(x.half(), x.half(), x.half(), 2, 1.0)
    with pytest.raises(TypeError):
        sa.short_attention_fwd(x, x.to(torch.bfloat16), x, 2, 1.0)
    with pytest.raises(ValueError, match="unit stride"):
        t = torch.randn(2, 128, 8, device=dev).transpose(1, 2)
        sa.short_attention_fwd(t, t, t, 2, 1.0)
    with pytest.raises(ValueError, match="D in"):
        y = torch.randn(2, 8, 96, device=dev)
        sa.short_attention_fwd(y, y, y, 2, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        sa.short_attention_fwd(x, x.cpu(), x, 2, 1.0)
    with pytest.raises(ValueError, match="16-byte"):
        u = torch.randn(2, 8, 130, device=dev).to(torch.bfloat16)[..., 2:]
        sa.short_attention_fwd(u, u, u, 2, 1.0)
