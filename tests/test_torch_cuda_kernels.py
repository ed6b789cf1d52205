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


def _ce_fns(layout):
    if layout == "nhwc":
        return (fused_tail.ce_cm_fwd_nhwc, fused_tail.ce_cm_bwd_nhwc,
                fused_tail.ce_cm_forward_plain, fused_tail.ce_cm_backward_plain)
    return (fused_tail.ce_cm_fwd_phase, fused_tail.ce_cm_bwd_phase,
            fused_tail.ce_cm_phase_forward_plain, fused_tail.ce_cm_phase_backward_plain)


def _ce_inputs(dev, layout, dtype, b, h, w, seed, ignore_all=False, offset=0):
    """Logits (a contiguous view ``offset`` elements into its buffer, so a
    non-zero offset leaves it off the 16-byte grid), int32 labels, weights."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, h, w, 3) if layout == "nhwc" else (b, h // 2, w // 2, 12)
    numel = b * h * w * 3
    buf = torch.randn(numel + offset, device=dev, generator=g).to(dtype)
    logits = buf[offset:].view(shape)
    labels = torch.randint(0, 4, (b, h, w), device=dev, generator=g, dtype=torch.int32)
    if ignore_all:
        labels.fill_(3)
    return logits, labels, torch.tensor(CW, device=dev)


def _ce_check(layout, dtype, logits, labels, cw, kernel):
    """Kernel against plain: loss and weight sum rtol 1e-5 (f32 sums in
    another order), cm exact, dlogits within 1e-5 (f32) or 1e-2 (bf16, one
    rounding) of max |dlogits|; repeats bitwise equal; one launch each way
    on the plan's unit."""
    fwd, bwd, plain_f, plain_b = _ce_fns(layout)
    b, h, w = labels.shape
    lay = fused_tail.NHWC if layout == "nhwc" else fused_tail.PHASE
    plan = fused_tail.ce_cm_plan(b * h * w, h, w, lay, dtype, fused_tail.alignment(logits, labels))
    assert plan.kernel == kernel
    n0 = [(f.launches, f.kernel_launches[kernel]) for f in (fwd, bwd)]
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
    assert [(f.launches, f.kernel_launches[kernel]) for f in (fwd, bwd)] == \
        [(a + 1, k + 1) for a, k in n0]
    again = fwd(logits, labels, cw)
    assert all(torch.equal(x, y) for x, y in zip((loss, cm, tw), again))
    assert torch.equal(d, bwd(logits, labels, cw, gs))
    return loss, cm, tw, d


# (B, H, W, unit of the NHWC call, unit of the PHASE call): the main shape;
# the odd shapes (NHWC's vector unit with a 4-pixel tail, PHASE's scalar
# unit, as W/2 is odd); a W % 8 == 0 PHASE shape with one unit per phase row
CE_SHAPES = [((128, 224, 224), "vector", "vector"), ((3, 18, 22), "vector", "scalar"),
             ((1, 12, 10), "vector", "scalar"), ((2, 6, 8), "vector", "vector"),
             ((1, 2, 2), "scalar", "scalar")]


@pytest.mark.parametrize("layout", ["nhwc", "phase"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,nhwc_kernel,phase_kernel", CE_SHAPES,
                         ids=["x".join(map(str, c[0])) for c in CE_SHAPES])
def test_ce_cm_kernels_match_plain(dev, shape, nhwc_kernel, phase_kernel, layout, dtype):
    logits, labels, cw = _ce_inputs(dev, layout, dtype, *shape, seed=sum(shape))
    _ce_check(layout, dtype, logits, labels, cw,
              nhwc_kernel if layout == "nhwc" else phase_kernel)


@pytest.mark.parametrize("layout", ["nhwc", "phase"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_cm_all_ignored_batch(dev, layout, dtype):
    """No pixel counts: weight sum clamped to 1e-12, loss 0, cm 0, dlogits 0."""
    logits, labels, cw = _ce_inputs(dev, layout, dtype, 4, 64, 64, seed=5, ignore_all=True)
    loss, cm, tw, d = _ce_check(layout, dtype, logits, labels, cw, "vector")
    assert loss.item() == 0.0 and tw.item() == pytest.approx(1e-12) and not cm.any()
    assert not d.float().any()


@pytest.mark.parametrize("layout", ["nhwc", "phase"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_cm_misaligned_view_takes_the_scalar_unit(dev, layout, dtype):
    logits, labels, cw = _ce_inputs(dev, layout, dtype, 2, 32, 32, seed=6, offset=1)
    assert fused_tail.alignment(logits) < 16
    _ce_check(layout, dtype, logits, labels, cw, "scalar")


def test_ce_cm_ticket_resets_over_ten_calls(dev):
    """The forward's last block folds the partials and sets the stream's
    ticket back to 0: ten calls in a row, of two sizes (two grids), agree
    bit for bit with the first."""
    big = _ce_inputs(dev, "nhwc", torch.bfloat16, 16, 224, 224, seed=7)
    small = _ce_inputs(dev, "nhwc", torch.bfloat16, 1, 40, 40, seed=8)
    first = [fused_tail.ce_cm_fwd_nhwc(*x) for x in (big, small)]
    for i in range(10):
        got = fused_tail.ce_cm_fwd_nhwc(*(big if i % 2 else small))
        want = first[0 if i % 2 else 1]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    ws = fused_tail._workspace(big[0].device)
    torch.cuda.synchronize()
    assert ws[0].item() == 0


def test_ce_cm_on_two_streams(dev):
    """Each stream has its own ticket: calls queued on two streams at once
    give the results of the same calls on the default stream."""
    inputs = [_ce_inputs(dev, "nhwc", torch.bfloat16, 32, 224, 224, seed=9 + i) for i in range(2)]
    want = [fused_tail.ce_cm_fwd_nhwc(*x) for x in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(5):
        for i, (s, x) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(s):
                got[i].append(fused_tail.ce_cm_fwd_nhwc(*x))
    torch.cuda.synchronize()
    for w_, runs in zip(want, got):
        for run in runs:
            assert all(torch.equal(a, b) for a, b in zip(run, w_))
    keys = {(dev.index or 0, s.cuda_stream) for s in streams}
    assert keys <= set(fused_tail._WORKSPACES)


def test_ce_cm_entry_points_refuse_a_unit_that_does_not_fit(dev):
    """The vector unit on a pointer off the 16-byte grid, or on a PHASE call
    with W % 8 != 0, is refused before any launch."""
    lib = fused_tail._lib()
    logits, labels, cw = _ce_inputs(dev, "nhwc", torch.bfloat16, 2, 16, 16, seed=10, offset=1)
    ws = fused_tail._workspace(logits.device)
    out = torch.empty(18, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    vector = fused_tail.CE_CM_KERNELS["vector"]
    err = lib.ks_ce_cm_fwd(logits.data_ptr(), labels.data_ptr(), cw.data_ptr(), ws.data_ptr(),
                           (ws.numel() - 1) // 11, out.data_ptr(), labels.numel(), 16, 16,
                           fused_tail.NHWC, 1, vector, stream)
    assert err != 0
    z, lab, _ = _ce_inputs(dev, "phase", torch.bfloat16, 1, 12, 12, seed=11)
    d = torch.empty_like(z)
    gs = torch.ones(1, device=dev)
    err = lib.ks_ce_cm_bwd(z.data_ptr(), lab.data_ptr(), cw.data_ptr(), gs.data_ptr(),
                           d.data_ptr(), lab.numel(), 12, 12, fused_tail.PHASE, 1, vector, stream)
    assert err != 0
    # a workspace smaller than the grid
    logits, labels, cw = _ce_inputs(dev, "nhwc", torch.bfloat16, 128, 224, 224, seed=12)
    err = lib.ks_ce_cm_fwd(logits.data_ptr(), labels.data_ptr(), cw.data_ptr(), ws.data_ptr(),
                           1, out.data_ptr(), labels.numel(), 224, 224, fused_tail.NHWC, 1,
                           vector, stream)
    assert err != 0


@pytest.mark.parametrize("layout", ["nhwc", "phase"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_cm_grid_fills_the_card(dev, layout, dtype):
    """At the main shape the grid is every block the card holds at once."""
    lay = fused_tail.NHWC if layout == "nhwc" else fused_tail.PHASE
    n = 128 * 224 * 224
    plan = fused_tail.ce_cm_plan(n, 224, 224, lay, dtype, 16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for fwd in (True, False):
        blocks, per_sm, regs = fused_tail.ce_cm_grid(fwd, lay, dtype, plan, n, 224, 224)
        assert 1 <= per_sm <= 8 and 0 < regs <= 255
        assert blocks == per_sm * sms


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


def _close(got, want, band, like=None):
    """max |got - want| within ``band`` of the largest |value| of ``like``
    (default ``want``)."""
    err = (got.float() - want.float()).abs().max().item()
    ref = want if like is None else like
    assert err <= band * ref.float().abs().max().item(), (err, band)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,heads,d", [(3, 49, 49, 4, 64), (2, 77, 77, 8, 32),
                                             (2, 130, 20, 2, 64), (1, 5, 200, 1, 128),
                                             (2, 196, 196, 16, 64), (1, 300, 300, 2, 64),
                                             (2, 3136, 4, 8, 64), (2, 1000, 49, 2, 64),
                                             (1, 257, 1, 2, 64)])
def test_short_attention_kernel_matches_plain(dev, b, nq, nk, heads, d, dtype):
    """Each call on the kernel its plan names: f32 the simt kernels; bf16 at
    D 64 with Nq, Nk <= 256 and at D 128 with Nk <= 128 the wgmma kernels;
    bf16 at D 64 with Nq > 256 over at most 64 keys (BiT-CD's decoder at 4
    keys, ChangeFormer's stage 2 at 49 over a ragged 1,000 queries, one key
    over 257) the wgmma_long kernels, k and v the column halves of one
    tensor as ChangeFormer's kv projection gives them; else (D 32, (1, 300,
    300) past 256 keys, (1, 5, 200) at D 128) the mma.sync ones. Bands as
    chip_smoke.py: f32 out and lse 1e-5, grads 1e-4 of each tensor's largest
    value (f32 sums in another order, online softmax); bf16 out 1e-2, lse
    1e-3, grads 2e-2 (the mma.sync forward divides by l at the end where the
    plain version rounds p/l; one bf16 rounding of p and ds in every
    backward). Over one key p = 1, so dP = delta and dq, dk are 0 in exact
    arithmetic: their rounding noise is held to the band of dv's largest
    value, the call's gradient scale. Two runs bitwise equal."""
    q, k, v, do = _attention_inputs(dev, b, nq, nk, heads, d, dtype, seed=nq + nk)
    scale = d**-0.5
    f32 = dtype == torch.float32
    kernel = sa.short_plan(dtype, d, nq, nk).kernel
    long = sa.long_route(d, nq, nk)
    assert kernel == ("simt" if f32 else "wgmma" if sa.wgmma_takes(d, nq, nk) else
                      "wgmma_long" if long else "mma_sync")
    if long:
        k, v = torch.cat([k, v], -1).chunk(2, dim=-1)
    n0 = sa.short_attention_fwd.launches, sa.short_attention_bwd.launches
    k0 = [f.kernel_launches[kernel] for f in (sa.short_attention_fwd, sa.short_attention_bwd)]
    out, lse = sa.short_attention_fwd(q, k, v, heads, scale)
    want_out, want_lse = sa.short_attention_fwd_plain(q, k, v, heads, scale)
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (b, heads, nq)
    _close(out, want_out, 1e-5 if f32 else 1e-2)
    assert (lse - want_lse).abs().max().item() <= (1e-5 * want_lse.abs().max().item() if f32
                                                   else 1e-3)
    delta = sa.attention_delta(do, want_out, heads)
    got = sa.short_attention_bwd(q, k, v, do, want_lse, want_out, heads, scale)
    want = sa.short_attention_bwd_plain(q, k, v, do, want_lse, delta, heads, scale)
    for g_, w_ in zip(got, want):
        assert g_.dtype == dtype
        _close(g_, w_, 1e-4 if f32 else 2e-2, like=want[2] if nk == 1 else None)
    again = sa.short_attention_bwd(q, k, v, do, want_lse, want_out, heads, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # deterministic
    out2, lse2 = sa.short_attention_fwd(q, k, v, heads, scale)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert (sa.short_attention_fwd.launches, sa.short_attention_bwd.launches) == (n0[0] + 2,
                                                                                 n0[1] + 2)
    assert [f.kernel_launches[kernel] for f in (sa.short_attention_fwd,
                                                sa.short_attention_bwd)] == [k0[0] + 2, k0[1] + 2]


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


@pytest.mark.parametrize("b,nq,nk,heads,d", [(64, 49, 49, 16, 64), (64, 196, 196, 16, 64),
                                             (2, 200, 130, 4, 64), (3, 13, 13, 2, 64),
                                             (2, 77, 120, 4, 128), (2, 40, 40, 2, 128),
                                             (2, 70, 70, 2, 128), (2, 256, 128, 2, 128)])
def test_wgmma_short_attention_matches_plain(dev, b, nq, nk, heads, d):
    """The Hopper kernels (wgmma fed by TMA) at the MAE ViT-L b64 encoder and
    decoder shapes (resident blocks walking the items; the decoder's 196
    keys end in a 16-key block), a ragged Nq != Nk shape, the small MAE's 13
    tokens and D 128, where (2, 256, 128) holds one item stage in the
    forward (one block an item) and one of K and V in the backward: bands as
    test_short_attention_kernel_matches_plain (bf16), two runs bitwise equal
    (no float atomics), every call on the wgmma kernels. Self-attention
    shapes read q, k, v as the thirds of one qkv tensor and write dq, dk, dv
    into the thirds of one gradient."""
    q, k, v, do = _attention_inputs(dev, b, nq, nk, heads, d, torch.bfloat16, seed=3 * nq + nk)
    if nq == nk:
        q, k, v = torch.cat([q, k, v], -1).chunk(3, dim=-1)
    scale = d**-0.5
    plan = sa.short_plan(torch.bfloat16, d, nq, nk)
    assert plan.kernel == "wgmma"
    n0 = [dict(f.kernel_launches) for f in (sa.short_attention_fwd, sa.short_attention_bwd)]
    out, lse = sa.launch_fwd(plan, q, k, v, heads, scale)
    want_out, want_lse = sa.short_attention_fwd_plain(q, k, v, heads, scale)
    _close(out, want_out, 1e-2)
    assert (lse - want_lse).abs().max().item() <= 1e-3
    out2, lse2 = sa.launch_fwd(plan, q, k, v, heads, scale)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    want = sa.short_attention_bwd_plain(q, k, v, do, want_lse,
                                        sa.attention_delta(do, want_out, heads), heads, scale)
    views = [None] * 3
    if nq == nk:
        dqkv = torch.full((b, nq, 3 * heads * d), float("nan"), device=dev, dtype=torch.bfloat16)
        views = dqkv.chunk(3, dim=-1)
    got = sa.launch_bwd(plan, q, k, v, do, want_lse, want_out, heads, scale, *views)
    for g_, w_ in zip(got, want):
        _close(g_, w_, 2e-2)
    again = sa.launch_bwd(plan, q, k, v, do, want_lse, want_out, heads, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for f, before in zip((sa.short_attention_fwd, sa.short_attention_bwd), n0):
        assert f.kernel_launches == dict(before, wgmma=before["wgmma"] + 2)


def test_short_plan_footprint_is_the_kernels_own(dev):
    for d, nq, nk in ((64, 49, 49), (64, 196, 196), (64, 200, 130), (64, 13, 13),
                      (128, 77, 120), (128, 40, 40), (128, 70, 70), (128, 256, 128),
                      (64, 3136, 4), (64, 784, 49), (64, 257, 32), (64, 300, 40)):
        plan = sa.short_plan(torch.bfloat16, d, nq, nk)
        smem, blocks = sa.kernel_footprint("fwd", d, nq, nk)
        assert smem == plan.fwd_smem and blocks >= 1
        smem, blocks = sa.kernel_footprint("bwd", d, nq, nk)
        assert smem == plan.bwd_smem and blocks >= 1
    assert sa.kernel_footprint("bwd", 64, 49, 49)[1] == 2  # the encoder's: two an SM
    for nk in (4, 32, 48, 64):  # the long-query kernels hold the blocks long_chunk counts on
        for which in ("fwd", "bwd"):
            assert sa.kernel_footprint(which, 64, 3136, nk)[1] == sa.long_blocks(which, nk)


def test_short_wrappers_raise_and_do_not_retry(dev):
    """A plan forced onto a call its kernel does not take raises from the C
    entry point before any launch: no counter moves, no other kernel runs."""
    g = torch.Generator(device=dev).manual_seed(3)
    fns = (sa.short_attention_fwd, sa.short_attention_bwd)
    before = [(f.launches, dict(f.kernel_launches)) for f in fns]
    refused = "launch: CUDA error 1 "
    wgmma = sa.short_plan(torch.bfloat16, 64, 49, 49)
    long = sa.short_plan(torch.bfloat16, 64, 3136, 4)
    cases = [(long, 64, 300, torch.bfloat16),  # wgmma_long past 64 keys
             (long, 32, 300, torch.bfloat16),  # wgmma_long at D 32
             (long, 64, 300, torch.float32),  # wgmma_long on f32
             (wgmma, 64, 300, torch.bfloat16),  # wgmma past 256 keys
             (wgmma, 32, 49, torch.bfloat16),  # wgmma at D 32
             (wgmma, 128, 130, torch.bfloat16),  # wgmma at D 128 past 128 keys
             (wgmma, 64, 49, torch.float32),  # wgmma on f32
             (sa.short_plan(torch.float32, 64, 49, 49), 64, 49, torch.bfloat16),  # simt on bf16
             (sa.short_plan(torch.bfloat16, 32, 49, 49), 64, 49, torch.float32)]  # mma_sync on f32
    for plan, d, n, dtype in cases:
        heads = 256 // d
        q, k, v, do = (torch.randn(2, n, 256, device=dev, generator=g).to(dtype)
                       for _ in range(4))
        lse = torch.zeros(2, heads, n, device=dev)
        with pytest.raises(RuntimeError, match=f"forward {plan.kernel} " + refused):
            sa.launch_fwd(plan, q, k, v, heads, 1.0)
        with pytest.raises(RuntimeError, match=f"backward {plan.kernel} " + refused):
            sa.launch_bwd(plan, q, k, v, do, lse, q, heads, 1.0)
    assert [(f.launches, f.kernel_launches) for f in fns] == before


def test_short_attention_qkv_on_the_card(dev):
    """The packed-qkv custom VJP on the wgmma kernels: no split or concat
    node between the output and the qkv leaf (the backward writes dq, dk, dv
    into the thirds of one gradient), and dqkv within the bf16 band of the
    plain version's on the same card inputs."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, n, heads, d = 4, 49, 4, 64
    qkv = torch.randn(b, n, 3 * heads * d, device=dev, generator=g).to(torch.bfloat16)
    do = torch.randn(b, n, heads * d, device=dev, generator=g).to(torch.bfloat16)
    leaf = qkv.clone().requires_grad_(True)
    n0 = dict(sa.short_attention_bwd.kernel_launches)
    out = sa.short_attention_qkv(leaf, heads)
    node = out.grad_fn
    assert "ShortAttentionQKV" in type(node).__name__
    assert [type(f).__name__ for f, _ in node.next_functions if f is not None] == \
        ["AccumulateGrad"]
    out.backward(do)
    assert sa.short_attention_bwd.kernel_launches == dict(n0, wgmma=n0["wgmma"] + 1)
    q, k, v = qkv.chunk(3, dim=-1)
    want_out, want_lse = sa.short_attention_fwd_plain(q, k, v, heads, d**-0.5)
    want = sa.short_attention_bwd_plain(q, k, v, do, want_lse,
                                        sa.attention_delta(do, want_out, heads), heads, d**-0.5)
    _close(out.detach(), want_out, 1e-2)
    for got, ref in zip(leaf.grad.chunk(3, dim=-1), want):
        _close(got, ref, 2e-2)


# ---------------------------------------------------------------- B5 flash


def _flash_inputs(dev, b, heads, nq, nk, d, dtype, seed, packed):
    """q, k, v (B, H, N, D) and do; with ``packed`` q, k, v are the head
    views of the column-thirds of one (B, N, 3*H*D) tensor, as the ViT's qkv
    projection hands them over (needs nq == nk)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if packed:
        qkv = torch.randn(b, nq, 3 * heads * d, device=dev, generator=g).to(dtype)
        q, k, v = (t.reshape(b, nq, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.randn(b, heads, nq, d, device=dev, generator=g).to(dtype)
        k, v = (torch.randn(b, heads, nk, d, device=dev, generator=g).to(dtype) for _ in range(2))
    do = torch.randn(b, heads, nq, d, device=dev, generator=g).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,nq,nk,d,packed", [
    (1, 4, 1024, 1024, 64, True), (2, 4, 1003, 1090, 32, False), (1, 2, 1024, 1024, 128, True),
    (1, 2, 70, 5, 64, False), (2, 3, 129, 200, 32, False),
])
def test_flash_attention_kernels_match_plain(dev, b, heads, nq, nk, d, packed, dtype):
    """Bands as chip_smoke.py: f32 out, lse and grads within 1e-5 of each
    tensor's largest value (the same f32 products summed in another order);
    bf16 out and grads within 2e-2 of each tensor's largest value, lse within
    1e-4 (the kernel rounds p and ds to bf16 as tensor-core
    operands, the plain version keeps them f32, as the TPU kernel does)."""
    from kurosiwo_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(dev, b, heads, nq, nk, d, dtype, nq + nk, packed)
    scale = d**-0.5
    f32 = dtype == torch.float32
    n0 = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
          fa.flash_attention_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, scale)
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, scale)
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (b, heads, nq)
    if f32:
        _close(out, want_out, 1e-5)
        _close(lse, want_lse, 1e-5)
    else:
        _close(out, want_out, 2e-2)
        assert (lse - want_lse).abs().max().item() <= 1e-4
    delta = fa.flash_delta(do, want_out)
    got = fa.flash_attention_bwd(q, k, v, do, want_lse, delta, scale)
    want = fa.flash_attention_bwd_plain(q, k, v, do, want_lse, delta, scale)
    for g_, w_, t in zip(got, want, (q, k, v)):
        assert g_.dtype == dtype and g_.shape == t.shape
        _close(g_, w_, 1e-5 if f32 else 2e-2)
    again = fa.flash_attention_bwd(q, k, v, do, want_lse, delta, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # deterministic
    out2, lse2 = fa.flash_attention_fwd(q, k, v, scale)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == (n0[0] + 2, n0[1] + 2, n0[2] + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_packed_autograd_on_the_card(dev, dtype):
    """attention_packed at N = 1024 (the flash route) through the custom VJP,
    q, k, v as strided thirds of one qkv tensor, card against CPU."""
    from kurosiwo_torch.ops import flash_attention as fa
    from kurosiwo_torch.ops.attention import attention_packed

    g = torch.Generator(device=dev).manual_seed(5)
    b, n, heads, d = 1, 1024, 2, 64
    qkv = torch.randn(b, n, 3 * heads * d, device=dev, generator=g).to(dtype).requires_grad_(True)
    do = torch.randn(b, n, heads * d, device=dev, generator=g).to(dtype)
    n0 = fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches
    out = attention_packed(*qkv.chunk(3, dim=-1), heads)
    out.backward(do)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches) == (n0[0] + 1,
                                                                               n0[1] + 1)
    ref = qkv.detach().cpu().requires_grad_(True)
    rout = attention_packed(*ref.chunk(3, dim=-1), heads)
    rout.backward(do.cpu())
    f32 = dtype == torch.float32
    _close(out.detach().cpu(), rout.detach(), 1e-5 if f32 else 2e-2)
    _close(qkv.grad.cpu(), ref.grad, 1e-5 if f32 else 2e-2)


def test_flash_attention_wrappers_raise_on_layouts_they_do_not_take(dev):
    from kurosiwo_torch.ops import flash_attention as fa

    x = torch.randn(1, 2, 64, 64, device=dev)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(x.half(), x.half(), x.half(), 1.0)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(x, x.to(torch.bfloat16), x, 1.0)
    with pytest.raises(ValueError, match="D in"):
        y = torch.randn(1, 2, 64, 48, device=dev)
        fa.flash_attention_fwd(y, y, y, 1.0)
    with pytest.raises(ValueError, match="unit stride"):
        t = torch.randn(1, 2, 64, 64, device=dev).transpose(2, 3)
        fa.flash_attention_fwd(t, t, t, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(x, x.cpu(), x, 1.0)
    with pytest.raises(ValueError, match="16-byte"):
        u = torch.randn(1, 2, 64, 72, device=dev).to(torch.bfloat16)[..., 4:68]
        fa.flash_attention_fwd(u, u, u, 1.0)


@pytest.mark.parametrize("b,heads,nq,nk,d,packed", [
    (1, 16, 4096, 4096, 64, True), (1, 4, 1024, 1024, 128, True), (2, 3, 1003, 1090, 64, False),
    (1, 2, 130, 257, 128, False),
])
def test_wgmma_flash_attention_matches_plain(dev, b, heads, nq, nk, d, packed):
    """The Hopper kernels (wgmma fed by TMA) at the scene encode's shape, D
    128 and ragged N at D 64 and 128, bf16: every call on them (counted by
    kernel), bands as test_flash_attention_kernels_match_plain, and two runs
    bitwise equal (no float atomics)."""
    from kurosiwo_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(dev, b, heads, nq, nk, d, torch.bfloat16, 7 * nq + nk, packed)
    scale = d**-0.5
    assert fa.flash_plan(torch.bfloat16, d, nq, nk).kernel == "wgmma"
    n0 = [dict(f.kernel_launches) for f in (fa.flash_attention_fwd, fa.flash_attention_dq,
                                            fa.flash_attention_dkv)]
    out, lse = fa.flash_attention_fwd(q, k, v, scale)
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, scale)
    _close(out, want_out, 2e-2)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    out2, lse2 = fa.flash_attention_fwd(q, k, v, scale)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    delta = fa.flash_delta(do, want_out)
    args = (q, k, v, do, want_lse, delta, scale)
    got = fa.flash_attention_bwd(*args)
    for g_, w_ in zip(got, fa.flash_attention_bwd_plain(*args)):
        _close(g_, w_, 2e-2)
    assert all(torch.equal(x, y) for x, y in zip(got, fa.flash_attention_bwd(*args)))
    for f, before, n in ((fa.flash_attention_fwd, n0[0], 2), (fa.flash_attention_dq, n0[1], 2),
                         (fa.flash_attention_dkv, n0[2], 2)):
        assert f.kernel_launches == dict(before, wgmma=before["wgmma"] + n)


def test_flash_plan_smem_is_the_kernels_own(dev):
    from kurosiwo_torch.ops import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        for d in fa.HEAD_DIMS:
            plan = fa.flash_plan(dtype, d, 1024, 1024)
            assert (plan.fwd_smem, plan.dq_smem, plan.dkv_smem) == tuple(
                fa.kernel_smem(plan.kernel, which, d) for which in ("fwd", "dq", "dkv"))


def test_flash_wrappers_raise_and_do_not_retry(dev):
    """A plan forced onto a call its kernel does not take raises from the C
    entry point before any launch: no counter moves, no other kernel runs."""
    from kurosiwo_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(3)
    fns = (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv)
    before = [(f.launches, dict(f.kernel_launches)) for f in fns]
    refused = "launch: CUDA error 1 "
    cases = [(fa.flash_plan(torch.bfloat16, 64, 256, 256), 32, torch.bfloat16),  # wgmma at D 32
             (fa.flash_plan(torch.bfloat16, 32, 256, 256), 64, torch.bfloat16),  # mma_sync at D 64
             (fa.flash_plan(torch.float32, 64, 256, 256), 64, torch.bfloat16),  # simt on bf16
             (fa.flash_plan(torch.bfloat16, 64, 256, 256), 64, torch.float32)]  # wgmma on f32
    for plan, d, dtype in cases:
        q, k, v, do = (torch.randn(1, 2, 256, d, device=dev, generator=g).to(dtype)
                       for _ in range(4))
        lse = torch.zeros(1, 2, 256, device=dev)
        with pytest.raises(RuntimeError, match=f"forward {plan.kernel} " + refused):
            fa.launch_fwd(plan, q, k, v, 1.0)
        with pytest.raises(RuntimeError, match=f"dq {plan.kernel} " + refused):
            fa.launch_dq(plan, q, k, v, do, lse, lse, 1.0)
        with pytest.raises(RuntimeError, match=f"dk/dv {plan.kernel} " + refused):
            fa.launch_dkv(plan, q, k, v, do, lse, lse, 1.0)
    assert [(f.launches, f.kernel_launches) for f in fns] == before


# ---------------------------------------------------------------- B6-B8 convs


def conv_band(got, want, scale, bf16):
    """Bands as chip_smoke.py: the kernel and the plain version sum the same
    f32 products in another order, so |got - want| <= 1e-5 * sum(|terms|)
    (``scale``, per element); a bf16 output adds one rounding of each side,
    at most 2^-8 of each value, so 2^-7 * |want| more."""
    err = (got.float() - want.float()).abs()
    band = 1e-5 * scale + 1e-6
    if bf16:
        band = band + 2.0**-7 * want.float().abs()
    assert bool((err <= band).all()), (err.max().item(), (err - band).max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("shape,cout", [((2, 7, 9, 256), 128), ((3, 14, 14, 256), 256),
                                        ((1, 5, 6, 24), 40), ((2, 8, 8, 768), 256)])
def test_conv3x3_bn_stats_kernel_matches_plain(dev, shape, cout, prologue, dtype):
    from kurosiwo_torch.ops import conv_bn
    from kurosiwo_torch.ops.conv_bn import conv3x3_plain_f32

    g = torch.Generator(device=dev).manual_seed(sum(shape) + cout)
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    w = (0.05 * torch.randn((3, 3, shape[-1], cout), device=dev, generator=g)).to(dtype)
    sb = None
    if prologue:
        sb = (torch.rand(shape[-1], device=dev, generator=g) + 0.5,
              0.1 * torch.randn(shape[-1], device=dev, generator=g))
    n0 = conv_bn.conv3x3_bn_stats.launches
    plan = conv_bn.conv3x3_plan(dtype, shape[0] * shape[1] * shape[2], shape[-1], cout,
                                "prologue" if prologue else "stats")
    k0 = conv_bn.conv3x3_bn_stats.kernel_launches[plan.kernel]
    y, st = conv_bn.conv3x3_bn_stats(x, w, *(sb or ()))
    want_y, want_st = conv_bn.conv3x3_bn_stats_plain(x, w, *(sb or ()))
    assert y.dtype == dtype and y.shape == (*shape[:3], cout) and st.shape == (2, cout)
    xa = x if sb is None else torch.relu(x.float() * sb[0] + sb[1]).to(dtype)
    scale = conv3x3_plain_f32(xa.abs(), w.abs())
    conv_band(y, want_y, scale, dtype == torch.bfloat16)
    # sum y moves by the sum of the y errors, sum y^2 by 2 |y| times each
    s = scale.reshape(-1, cout)
    conv_band(st, want_st, torch.stack([s.sum(0), 2 * (want_y.float().abs().reshape(-1, cout)
                                                       * s).sum(0)]), False)
    y2, st2 = conv_bn.conv3x3_bn_stats(x, w, *(sb or ()))
    assert torch.equal(y, y2) and torch.equal(st, st2)  # deterministic
    assert conv_bn.conv3x3_bn_stats.launches == n0 + 2
    assert conv_bn.conv3x3_bn_stats.kernel_launches[plan.kernel] == k0 + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [((2, 7, 9, 128), 128), ((4, 28, 28, 128), 128),
                                        ((2, 6, 5, 384), 128), ((1, 9, 7, 24), 16)])
def test_conv3x3_dw_kernel_matches_plain(dev, shape, cout, dtype):
    from kurosiwo_torch.ops import conv_dw

    g = torch.Generator(device=dev).manual_seed(sum(shape) + cout)
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    dy = torch.randn((*shape[:3], cout), device=dev, generator=g).to(dtype)
    n0 = conv_dw.conv3x3_dw.launches
    kernel = "wgmma" if dtype == torch.bfloat16 else "simt"
    k0 = conv_dw.conv3x3_dw.kernel_launches[kernel]
    got = conv_dw.conv3x3_dw(x, dy)
    want = conv_dw.conv3x3_dw_plain(x, dy)
    assert got.dtype == torch.float32 and got.shape == (3, 3, shape[-1], cout)
    conv_band(got, want, conv_dw.conv3x3_dw_plain(x.abs(), dy.abs()), False)
    assert torch.equal(got, conv_dw.conv3x3_dw(x, dy))  # deterministic
    assert conv_dw.conv3x3_dw.launches == n0 + 2
    assert conv_dw.conv3x3_dw.kernel_launches[kernel] == k0 + 2


# B6's and B7's wgmma kernels at a routed shape of the b128 step, at a ragged
# shape (pixels that fill no tile, a halo on every side) and at Cin 64 (one
# K chunk a tap), all in 192-pixel tiles
@pytest.mark.parametrize("shape,cout", [((128, 7, 7, 512), 512), ((48, 14, 14, 256), 256),
                                        ((3, 7, 7, 256), 256), ((2, 9, 11, 64), 128)])
def test_wgmma_conv3x3_bn_stats_matches_plain(dev, shape, cout):
    from kurosiwo_torch.ops import conv_bn
    from kurosiwo_torch.ops.conv_bn import conv3x3_plain_f32

    b, h, w, cin = shape
    assert conv_bn.conv3x3_plan(torch.bfloat16, b * h * w, cin, cout).kernel == "wgmma"
    g = torch.Generator(device=dev).manual_seed(cin + cout + b)
    x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    wt = (torch.randn((3, 3, cin, cout), device=dev, generator=g) / (3 * cin**0.5)).to(
        torch.bfloat16)
    k0 = conv_bn.conv3x3_bn_stats.kernel_launches["wgmma"]
    y, st = conv_bn.conv3x3_bn_stats(x, wt)
    y2, st2 = conv_bn.conv3x3_bn_stats(x, wt)
    assert conv_bn.conv3x3_bn_stats.kernel_launches["wgmma"] == k0 + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)
    want_y, want_st = conv_bn.conv3x3_bn_stats_plain(x, wt)
    scale = conv3x3_plain_f32(x.abs(), wt.abs())
    conv_band(y, want_y, scale, True)
    s = scale.reshape(-1, cout)
    conv_band(st, want_st, torch.stack([s.sum(0), 2 * (want_y.float().abs().reshape(-1, cout)
                                                       * s).sum(0)]), False)


@pytest.mark.parametrize("shape,cout", [((128, 28, 28, 128), 128), ((2, 9, 11, 128), 128),
                                        ((4, 8, 8, 64), 128), ((3, 6, 5, 200), 72)])
def test_wgmma_conv3x3_dw_matches_plain(dev, shape, cout):
    from kurosiwo_torch.ops import conv_dw

    g = torch.Generator(device=dev).manual_seed(sum(shape) + cout)
    x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    dy = torch.randn((*shape[:3], cout), device=dev, generator=g).to(torch.bfloat16)
    k0 = conv_dw.conv3x3_dw.kernel_launches["wgmma"]
    got = conv_dw.conv3x3_dw(x, dy)
    assert conv_dw.conv3x3_dw.kernel_launches["wgmma"] == k0 + 1
    assert torch.equal(got, conv_dw.conv3x3_dw(x, dy))
    conv_band(got, conv_dw.conv3x3_dw_plain(x, dy), conv_dw.conv3x3_dw_plain(x.abs(), dy.abs()),
              False)


def test_wgmma_wrappers_raise_and_do_not_retry(dev):
    """A plan that names a kernel which does not take the call raises before
    any launch (the C entry point refuses it): no counter moves, and no
    other kernel is tried."""
    from kurosiwo_torch.ops import conv_bn, conv_dw

    x = torch.randn(2, 6, 6, 24, device=dev).to(torch.bfloat16)
    w = torch.randn(3, 3, 24, 128, device=dev).to(torch.bfloat16)
    before = (dict(conv_bn.conv3x3_bn_stats.kernel_launches),
              dict(conv_dw.conv3x3_dw.kernel_launches))
    refused = "launch: CUDA error 1 "
    with pytest.raises(RuntimeError, match="wgmma " + refused):  # Cin 24: no multiple of 64
        conv_bn.launch_bn_stats(conv_bn.ConvPlan("wgmma", 1), x, w)
    x64 = torch.randn(2, 6, 6, 64, device=dev).to(torch.bfloat16)
    w64 = torch.randn(3, 3, 64, 128, device=dev).to(torch.bfloat16)
    sb = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(RuntimeError, match="wgmma " + refused):  # the kernel has no prologue
        conv_bn.launch_bn_stats(conv_bn.ConvPlan("wgmma", 1), x64, w64, *sb)
    with pytest.raises(RuntimeError, match="wgmma " + refused):  # f32 on the bf16 kernel
        conv_bn.launch_bn_stats(conv_bn.ConvPlan("wgmma", 1), x64.float(), w64.float())
    dy = torch.randn(2, 6, 6, 128, device=dev).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="simt " + refused):  # bf16 on the f32 kernel
        conv_dw.launch_dw(conv_dw.conv3x3_dw_plan(torch.float32, 72, 64, 128), x64, dy)
    with pytest.raises(RuntimeError, match="wgmma " + refused):  # a slice: no multiple of 64
        conv_dw.launch_dw(conv_dw.DwPlan("wgmma", 64, 1, 96, 3), x64, dy)
    with pytest.raises(ValueError, match="16-byte"):
        u = torch.randn(2 * 6 * 6 * 64 + 1, device=dev).to(torch.bfloat16)[1:].view(2, 6, 6, 64)
        conv_dw.conv3x3_dw(u, dy)
    assert (conv_bn.conv3x3_bn_stats.kernel_launches, conv_dw.conv3x3_dw.kernel_launches) == \
        before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,cout", [((2, 32, 16, 8), 4), ((1, 16, 17, 6), 6),
                                        ((2, 20, 22, 16), 16), ((2, 11, 13, 32), 32),
                                        ((1, 9, 10, 40), 24)])
def test_conv3x3_fused_kernel_matches_plain(dev, shape, cout, relu, dtype):
    from kurosiwo_torch.ops import conv_fused
    from kurosiwo_torch.ops.conv_bn import conv3x3_plain_f32

    g = torch.Generator(device=dev).manual_seed(sum(shape) + cout)
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    w = torch.randn((3, 3, shape[-1], cout), device=dev, generator=g).to(dtype)
    b = torch.randn(cout, device=dev, generator=g)
    n0 = conv_fused.conv3x3_fused.launches
    got = conv_fused.conv3x3_fused(x, w, b, relu)
    want = conv_fused.conv3x3_fused_plain(x, w, b, relu)
    assert got.dtype == dtype and got.shape == (*shape[:3], cout)
    conv_band(got, want, conv3x3_plain_f32(x.abs(), w.abs()) + b.abs(), dtype == torch.bfloat16)
    assert torch.equal(got, conv_fused.conv3x3_fused(x, w, b, relu))
    assert conv_fused.conv3x3_fused.launches == n0 + 2
    if not relu:
        assert got.float().min().item() < 0


def _fused_inputs(dev, shape, cout, seed, offset=0):
    """bf16 x (a view ``offset`` elements into its buffer) whose edge pixels
    are 64 times larger, so a halo read from the wrong place shows; w scaled
    to keep y near 1; f32 bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, device=dev, generator=g)
    for edge in (x[:, 0], x[:, -1], x[:, :, 0], x[:, :, -1]):
        edge *= 64
    buf = torch.empty(x.numel() + offset, device=dev, dtype=torch.bfloat16)
    x = buf[offset:].view(shape).copy_(x)
    w = (torch.randn((3, 3, shape[-1], cout), device=dev, generator=g) / (3 * shape[-1]**0.5))
    return x, w.to(torch.bfloat16), 0.1 * torch.randn(cout, device=dev, generator=g)


# the slab kernel (bf16): H no multiple of the band's R (a short last band),
# W = 254 (the 256-pixel halo box's edge), W whose half band is no multiple
# of 64 pixels (tiles across rows), Cin and Cout of 48 and 64 (two consumer
# warpgroups), more bands than the grid (the persistent walk wraps)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,cout", [((3, 21, 37, 32), 16), ((1, 10, 254, 16), 16),
                                        ((2, 9, 10, 48), 48), ((2, 9, 10, 64), 64),
                                        ((2, 12, 30, 16), 64), ((2, 13, 20, 64), 32),
                                        ((64, 50, 60, 32), 16)])
def test_slab_conv3x3_matches_plain(dev, shape, cout, relu):
    from kurosiwo_torch.ops import conv_fused
    from kurosiwo_torch.ops.conv_bn import conv3x3_plain_f32

    b, h, w, cin = shape
    x, wt, bias = _fused_inputs(dev, shape, cout, sum(shape) + cout)
    plan = conv_fused.conv3x3_fused_plan(torch.bfloat16, b, h, w, cin, cout, True,
                                         conv_fused.sm_count(x.device.index))
    assert plan.kernel == "slab"
    if shape[0] == 64:
        assert b * -(-h // plan.rows) > plan.grid
    k0 = conv_fused.conv3x3_fused.kernel_launches["slab"]
    got = conv_fused.conv3x3_fused(x, wt, bias, relu)
    assert torch.equal(got, conv_fused.conv3x3_fused(x, wt, bias, relu))  # deterministic
    assert conv_fused.conv3x3_fused.kernel_launches["slab"] == k0 + 2
    want = conv_fused.conv3x3_fused_plain(x, wt, bias, relu)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, cout)
    conv_band(got, want, conv3x3_plain_f32(x.abs(), wt.abs()) + bias.abs(), True)


@pytest.mark.parametrize("shape,cout", [((2, 20, 22, 16), 16), ((3, 21, 37, 32), 16),
                                        ((2, 9, 10, 48), 48)])
def test_slab_and_mma_sync_agree(dev, shape, cout):
    """The slab kernel and the mma.sync kernel it replaced, on the same
    inputs: each within the band of the plain version, and of each other."""
    from kurosiwo_torch.ops import conv_fused
    from kurosiwo_torch.ops.conv_bn import conv3x3_plain_f32

    b, h, w, cin = shape
    x, wt, bias = _fused_inputs(dev, shape, cout, 3 * cin + cout)
    plan = conv_fused.conv3x3_fused_plan(torch.bfloat16, b, h, w, cin, cout, True,
                                         conv_fused.sm_count(x.device.index))
    slab = conv_fused.launch_fused(plan, x, wt, bias)
    mma = conv_fused.launch_fused(plan._replace(kernel="mma_sync"), x, wt, bias)
    scale = conv3x3_plain_f32(x.abs(), wt.abs()) + bias.abs()
    want = conv_fused.conv3x3_fused_plain(x, wt, bias)
    conv_band(slab, want, scale, True)
    conv_band(mma, want, scale, True)
    conv_band(slab, mma, scale, True)


def test_a_view_off_the_16_byte_grid_takes_mma_sync(dev):
    from kurosiwo_torch.ops import conv_fused
    from kurosiwo_torch.ops.conv_bn import conv3x3_plain_f32

    x, wt, bias = _fused_inputs(dev, (2, 11, 13, 32), 32, 5, offset=1)
    assert x.data_ptr() % 16 and x.is_contiguous()
    before = dict(conv_fused.conv3x3_fused.kernel_launches)
    got = conv_fused.conv3x3_fused(x, wt, bias)
    assert conv_fused.conv3x3_fused.kernel_launches == dict(before, mma_sync=before["mma_sync"] + 1)
    conv_band(got, conv_fused.conv3x3_fused_plain(x, wt, bias),
              conv3x3_plain_f32(x.abs(), wt.abs()) + bias.abs(), True)


def test_slab_smem_is_the_kernels_own(dev):
    from kurosiwo_torch.ops import conv_fused

    for b, h, w, cin, cout in [(128, 224, 224, 16, 16), (128, 112, 112, 32, 32),
                               (3, 21, 37, 32, 16), (1, 10, 254, 16, 16), (2, 9, 10, 64, 64)]:
        plan = conv_fused.conv3x3_fused_plan(torch.bfloat16, b, h, w, cin, cout, True)
        assert plan.smem == conv_fused.slab_smem_of_kernel(w, cin, cout, plan.rows) > 0
    assert conv_fused.slab_smem_of_kernel(254, 64, 64, 2) == 0  # does not fit: refused


@pytest.mark.parametrize("shape,cout", [((128, 224, 224, 16), 16), ((128, 112, 112, 32), 32),
                                        ((64, 50, 60, 32), 16), ((2, 9, 10, 16), 16),
                                        ((2, 9, 10, 48), 48), ((2, 9, 10, 64), 64),
                                        ((4, 17, 100, 64), 32), ((1, 10, 254, 16), 16)])
def test_slab_grid_is_the_blocks_the_card_holds(dev, shape, cout):
    """The plan's grid (one block an SM, at most one a band) is the blocks
    the card holds at once by the kernel's own occupancy (threads,
    registers and shared memory): no block waits for a second wave, and no
    SM that could hold another block is left with one."""
    from kurosiwo_torch.ops import conv_fused

    b, h, w, cin = shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = conv_fused.conv3x3_fused_plan(torch.bfloat16, b, h, w, cin, cout, True, sms)
    per_sm = conv_fused.slab_blocks_per_sm(w, cin, cout, plan.rows)
    assert plan.kernel == "slab" and per_sm >= 1
    assert plan.grid == min(b * -(-h // plan.rows), sms * per_sm)


def test_slab_refuses_a_plan_that_does_not_fit(dev):
    """A slab plan the kernel does not take raises before any launch (the C
    entry point refuses it): no counter moves, and no other kernel is
    tried."""
    from kurosiwo_torch.ops import conv_fused

    slab = conv_fused.FusedPlan("slab", 8, 0, 4)
    before = dict(conv_fused.conv3x3_fused.kernel_launches)
    refused = "slab launch: CUDA error 1 "
    for shape, cout, plan, offset in [((2, 9, 10, 40), 24, slab, 0),      # Cin 40, Cout 24
                                      ((2, 9, 10, 16), 16, slab._replace(rows=7), 0),  # odd R
                                      ((1, 4, 255, 16), 16, slab, 0),     # W + 2 > 256
                                      ((2, 9, 254, 64), 64, slab, 0),     # no fit in 227 KB
                                      ((2, 9, 10, 16), 16, slab, 1)]:     # x off 16 bytes
        x, wt, bias = _fused_inputs(dev, shape, cout, 1, offset)
        with pytest.raises(RuntimeError, match=refused):
            conv_fused.launch_fused(plan, x, wt, bias)
    assert conv_fused.conv3x3_fused.kernel_launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["conv_bn_kernel", "dw_kernel"])
def test_conv_routes_autograd_on_the_card(dev, route, dtype):
    """A train-mode ConvBNAct on the route, card (kernels) against CPU
    (plain versions): output, running statistics and gradients, within
    1e-4 of each tensor's max in f32 (TF32 off) and 3e-2 in bf16 (a few
    roundings of 2^-8 between the two sides' orders of summation); f32
    runs the CUDA-core kernels, bf16 the wgmma ones."""
    from kurosiwo_torch.ops import conv_bn, conv_dw
    from kurosiwo_torch.ops.nn import ConvBNAct

    cin = 256 if route == "conv_bn_kernel" else 128
    g = torch.Generator().manual_seed(7)
    cpu = ConvBNAct(cin, cin, generator=g, **{route: True})
    gpu = ConvBNAct(cin, cin, **{route: True}).to(dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 8, 8, cin, generator=g)
    kernel = "simt" if dtype == torch.float32 else "wgmma"
    n0 = conv_bn.conv3x3_bn_stats.launches, conv_dw.conv3x3_dw.launches
    k0 = (conv_bn.conv3x3_bn_stats.kernel_launches[kernel],
          conv_dw.conv3x3_dw.kernel_launches[kernel])
    res = []
    for m, xin in ((cpu, x), (gpu, x.to(dev))):
        m.train()
        xin = xin.clone().requires_grad_(True)
        out = m(xin, dtype)
        (out.float() * out.float()).sum().backward()
        res.append([t.detach().cpu() for t in (out, xin.grad, m.Conv_0.weight.grad,
                                               m.BatchNorm_0.scale.grad, m.BatchNorm_0.mean,
                                               m.BatchNorm_0.var)])
    want = (1, 0) if route == "conv_bn_kernel" else (0, 1)
    assert (conv_bn.conv3x3_bn_stats.launches - n0[0], conv_dw.conv3x3_dw.launches - n0[1]) == \
        want
    assert (conv_bn.conv3x3_bn_stats.kernel_launches[kernel] - k0[0],
            conv_dw.conv3x3_dw.kernel_launches[kernel] - k0[1]) == want
    for got, want in zip(*res[::-1]):
        _close(got, want, 1e-4 if dtype == torch.float32 else 3e-2)


def test_conv_wrappers_raise_on_shapes_they_do_not_take(dev):
    from kurosiwo_torch.ops import conv_bn, conv_dw, conv_fused

    x = torch.randn(2, 6, 6, 16, device=dev)
    w = torch.randn(3, 3, 16, 8, device=dev)
    with pytest.raises(TypeError):
        conv_bn.conv3x3_bn_stats(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        conv_bn.conv3x3_bn_stats(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match=r"\(3, 3, Cin, Cout\)"):
        conv_bn.conv3x3_bn_stats(x, torch.randn(3, 3, 8, 8, device=dev))
    with pytest.raises(ValueError, match="multiples of 8"):
        conv_dw.conv3x3_dw(torch.randn(2, 6, 6, 6, device=dev), torch.randn(2, 6, 6, 8, device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        conv_fused.conv3x3_fused(x, w, torch.zeros(8))
    with pytest.raises(TypeError):
        conv_fused.conv3x3_fused(x.half(), w.half(), torch.zeros(8, device=dev))


def test_ring_attention_on_the_card_launches_b5_or_raises(dev):
    """Two shards of 1,024 (the flash route): B5's forward, dq and dk/dv
    twice a shard, the output and gradients in B5's bf16 band of
    whole-sequence flash attention; shards off the route raise."""
    from kurosiwo_torch.ops import flash_attention as fa
    from kurosiwo_torch.ops import ring_attention as ra

    g = torch.Generator(device=dev).manual_seed(0)
    leaves = [torch.randn((1, 2, 2048, 64), device=dev, generator=g).bfloat16().requires_grad_()
              for _ in range(3)]
    fns = (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv)
    before = [fn.launches for fn in fns]
    outs = ra.ring_attention_shards(*[list(t.chunk(2, dim=2)) for t in leaves])
    grads = torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs])
    assert [fn.launches - n for fn, n in zip(fns, before)] == [4, 4, 4]
    whole = [t.detach().requires_grad_() for t in leaves]
    ref = fa.flash_attention(*whole)
    want = (ref, *torch.autograd.grad(ref, whole, torch.ones_like(ref)))
    for got, w in zip((torch.cat(outs, dim=2), *grads), want):
        assert (got.float() - w.float()).abs().max() <= 2e-2 * w.float().abs().max()
    short = torch.zeros((1, 2, 64, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="flash"):
        ra.ring_attention_shards([short, short], [short, short], [short, short])
