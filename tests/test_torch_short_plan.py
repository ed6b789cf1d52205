"""The launch plan of the short-attention kernels (``short_attention.
short_plan``, B4): a pure function of dtype and shape that the wrappers pass
to csrc/short_attention.cu, so the CPU can pin which kernel each call takes
and that every plan's shared memory fits one block on an H100. The card
tests (tests/test_torch_cuda_kernels.py) hold the plan's numbers to the
built kernels' own and show that the entry points refuse a plan that does
not fit.
"""

import pytest
import torch

from kurosiwo_torch.ops import short_attention as sa
from kurosiwo_torch.ops.attention import _flash_route

BF16, F32 = torch.bfloat16, torch.float32

# (name, dtype, D, Nq, Nk, kernel): the MAE ViT-L b64 encoder (49 kept
# tokens) and decoder (196), chip_smoke.py's small MAE (13 kept of 49, and
# its 50-token decoder with the cls token), a ragged Nq != Nk shape, D 128,
# and the calls the wgmma kernels do not take
PLANS = [
    ("MAE encoder", BF16, 64, 49, 49, "wgmma"),
    ("MAE decoder", BF16, 64, 196, 196, "wgmma"),
    ("small MAE encoder", BF16, 64, 13, 13, "wgmma"),
    ("small MAE decoder", BF16, 64, 50, 50, "wgmma"),
    ("ragged D64", BF16, 64, 200, 130, "wgmma"),
    ("D128", BF16, 128, 77, 120, "wgmma"),
    ("N 3136", BF16, 64, 3136, 3136, "mma_sync"),
    ("Nq 257", BF16, 64, 257, 49, "mma_sync"),
    ("D128 Nk 129", BF16, 128, 64, 129, "mma_sync"),
    ("D32", BF16, 32, 77, 77, "mma_sync"),
    ("f32 encoder", F32, 64, 49, 49, "simt"),
    ("f32 D128", F32, 128, 200, 130, "simt"),
]


@pytest.mark.parametrize("name,dtype,d,nq,nk,kernel", PLANS, ids=[p[0] for p in PLANS])
def test_each_call_takes_its_kernel(name, dtype, d, nq, nk, kernel):
    plan = sa.short_plan(dtype, d, nq, nk)
    assert plan.kernel == kernel and plan.kernel in sa.SHORT_KERNELS
    if dtype == BF16:
        assert sa.wgmma_takes(d, nq, nk) == (kernel == "wgmma")
    assert not _flash_route(nq, nk)  # every one of these reaches the short route


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("nk", [1, 49, 64, 65, 128, 129, 196, 256])
def test_every_wgmma_plans_shared_memory_fits_a_block(d, nk):
    for nq in range(1, 257, 5):
        if not sa.wgmma_takes(d, nq, nk):
            continue
        assert 0 < sa.wgmma_fwd_smem(d, nq, nk) <= sa.SMEM_LIMIT == 227 * 1024
        assert 0 < sa.wgmma_bwd_smem(d, nk) <= sa.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", sa.HEAD_DIMS)
def test_every_plans_shared_memory_fits_a_block(dtype, d):
    for nq, nk in ((49, 49), (196, 196), (3136, 3136)):
        plan = sa.short_plan(dtype, d, nq, nk)
        assert 0 < plan.fwd_smem <= sa.SMEM_LIMIT and 0 < plan.bwd_smem <= sa.SMEM_LIMIT


def test_main_path_layouts():
    """The encoder's item (one 64-row tile each of Q, K, V) takes two stages
    of 24 KB; its backward one consumer warpgroup with two item stages of K
    and V, a ring of two (Q, dO, out) stages and 8 KB of dS^T, small enough
    for two blocks an SM. The decoder's forward holds two 96 KB stages (four
    tiles each of Q, K, V) with two warpgroups; its backward two consumer
    warpgroups of 128 keys each and 210 KB."""
    enc = sa.short_plan(BF16, 64, 49, 49)
    assert (enc.fwd_threads, enc.bwd_threads) == (128, 256)
    assert enc.fwd_smem == 2 * (3 * 8192 + 8) + 1024
    assert enc.bwd_smem == 2 * 2 * 8192 + 2 * (3 * 8192 + 512) + 8192 + 80 + 1024
    assert 2 * enc.bwd_smem <= sa.SMEM_LIMIT
    dec = sa.short_plan(BF16, 64, 196, 196)
    assert (dec.fwd_threads, dec.bwd_threads) == (256, 384)
    assert dec.fwd_smem == 2 * (12 * 8192 + 8) + 1024
    assert dec.bwd_smem == 2 * 8 * 8192 + 2 * (3 * 8192 + 512) + 4 * 8192 + 80 + 1024
    # D 128 at Nk 128: one item stage of K and V is all that fits
    big = sa.wgmma_bwd_smem(128, 128)
    assert big == 4 * 16384 + 2 * (3 * 16384 + 512) + 2 * 8192 + 80 + 1024


def test_one_item_a_block_takes_one_stage():
    """The forward holds two item stages where they fit (resident blocks walk
    the items), else one (one block an item)."""
    assert sa.wgmma_fwd_stages(64, 49, 49) == sa.wgmma_fwd_stages(64, 196, 196) == 2
    # two stages of the D-128 (256 x 128) item (8 tiles of 16 KB) do not fit: one
    assert sa.wgmma_fwd_stages(128, 256, 128) == 1
    assert sa.wgmma_fwd_smem(128, 256, 128) == 8 * 16384 + 8 + 1024


def test_plan_is_cached_and_refuses_what_no_kernel_takes():
    assert sa.short_plan(BF16, 64, 49, 49) is sa.short_plan(BF16, 64, 49, 49)
    with pytest.raises(TypeError):
        sa.short_plan(torch.float16, 64, 49, 49)
    with pytest.raises(ValueError, match="D = 48"):
        sa.short_plan(BF16, 48, 49, 49)
    with pytest.raises(ValueError):
        sa.short_plan(BF16, 64, 0, 49)


def test_wrappers_count_launches_by_plan_kernel():
    for fn in (sa.short_attention_fwd, sa.short_attention_bwd):
        assert set(fn.kernel_launches) == set(sa.SHORT_KERNELS)
        assert isinstance(fn.launches, int)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 49, 128, generator=g) for _ in range(4))
    counts = [(fn.launches, dict(fn.kernel_launches))
              for fn in (sa.short_attention_fwd, sa.short_attention_bwd)]
    out, lse = sa.short_attention_fwd(q, k, v, 2, 0.125)
    want_out, want_lse = sa.short_attention_fwd_plain(q, k, v, 2, 0.125)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    got = sa.short_attention_bwd(q, k, v, do, lse, out, 2, 0.125)
    want = sa.short_attention_bwd_plain(q, k, v, do, lse, sa.attention_delta(do, out, 2), 2, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [(fn.launches, fn.kernel_launches)
            for fn in (sa.short_attention_fwd, sa.short_attention_bwd)] == counts
