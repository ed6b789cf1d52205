"""The launch plan of the flash-attention kernels (``flash_attention.
flash_plan``, B5): a pure function of dtype and shape that the wrappers pass
to csrc/flash_attention.cu, so the CPU can pin which kernel each call takes
and that every plan's shared memory fits one block on an H100. The card
tests (tests/test_torch_cuda_kernels.py) hold the plan's numbers to the
built kernels' own and show that the entry points refuse a plan that does
not fit.
"""

import pytest
import torch

from kurosiwo_torch.ops import flash_attention as fa
from kurosiwo_torch.ops.attention import _flash_route

BF16, F32 = torch.bfloat16, torch.float32

# (name, dtype, D, Nq, Nk, kernel): the whole-scene ViT-L encode's call (24
# per encode), D 128, ragged N at D 64 and the ragged D-32 shape of the card
# checks (chip_smoke.py's FLASH_MAIN and FLASH_EXTRA)
PLANS = [
    ("scene ViT-L", BF16, 64, 4096, 4096, "wgmma"),
    ("D128", BF16, 128, 1024, 1024, "wgmma"),
    ("ragged D64", BF16, 64, 1003, 1090, "wgmma"),
    ("short ragged D64", BF16, 64, 70, 5, "wgmma"),
    ("ragged D32", BF16, 32, 1003, 1090, "mma_sync"),
    ("f32 scene", F32, 64, 4096, 4096, "simt"),
    ("f32 D32", F32, 32, 1003, 1090, "simt"),
    ("f32 D128", F32, 128, 1024, 1024, "simt"),
]


@pytest.mark.parametrize("name,dtype,d,nq,nk,kernel", PLANS, ids=[p[0] for p in PLANS])
def test_each_call_takes_its_kernel(name, dtype, d, nq, nk, kernel):
    plan = fa.flash_plan(dtype, d, nq, nk)
    assert plan.kernel == kernel
    assert plan.kernel in fa.FLASH_KERNELS
    rows = 128 if kernel == "wgmma" else 64
    assert (plan.q_tile, plan.k_tile) == (rows, rows)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_every_plans_shared_memory_fits_a_block(dtype, d):
    plan = fa.flash_plan(dtype, d, 4096, 4096)
    for smem in (plan.fwd_smem, plan.dq_smem, plan.dkv_smem):
        assert 0 < smem <= fa.SMEM_LIMIT == 227 * 1024


def test_scene_encode_grid_is_512_blocks_of_the_wgmma_kernels():
    """32 query tiles x 16 heads: 3.9 waves of one block per SM on the 132
    SMs; the D-64 blocks need under half of the 227 KB."""
    plan = fa.flash_plan(BF16, 64, 4096, 4096)
    assert -(-4096 // plan.q_tile) * 16 == 512
    assert max(plan.fwd_smem, plan.dq_smem, plan.dkv_smem) < fa.SMEM_LIMIT // 2
    assert _flash_route(4096, 4096)


def test_wgmma_shared_memory_is_the_kernels_layout():
    """Q 128 x D and two stages of 128-key K and V tiles for the forward;
    own 128-row tiles plus four stages of 64-row tiles for the backward (and
    64 lse and delta values a stage for dk/dv), mbarriers and 1 KB of
    alignment slack."""
    plan = fa.flash_plan(BF16, 64, 4096, 4096)
    assert plan.fwd_smem == 128 * 64 * 2 * 5 + 8 * 9 + 1024
    assert plan.dq_smem == 2 * 128 * 64 * 2 + 4 * 2 * 64 * 64 * 2 + 8 * 9 + 1024
    assert plan.dkv_smem == plan.dq_smem + 4 * 512
    big = fa.flash_plan(BF16, 128, 1024, 1024)
    assert (big.fwd_smem, big.dq_smem, big.dkv_smem) == (164936, 197704, 199752)


def test_plan_is_cached_and_refuses_what_no_kernel_takes():
    assert fa.flash_plan(BF16, 64, 4096, 4096) is fa.flash_plan(BF16, 64, 4096, 4096)
    with pytest.raises(TypeError):
        fa.flash_plan(torch.float16, 64, 4096, 4096)
    with pytest.raises(ValueError, match="D = 48"):
        fa.flash_plan(BF16, 48, 4096, 4096)
    with pytest.raises(ValueError):
        fa.flash_plan(BF16, 64, 0, 4096)


def test_wrappers_count_launches_by_plan_kernel():
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv):
        assert set(fn.kernel_launches) == set(fa.FLASH_KERNELS)
        assert isinstance(fn.launches, int)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 130, 64, generator=g) for _ in range(4))
    before = (fa.flash_attention_fwd.launches, dict(fa.flash_attention_fwd.kernel_launches))
    out, lse = fa.flash_attention_fwd(q, k, v, 0.125)
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, 0.125)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, do, lse, fa.flash_delta(do, out), 0.125)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_fwd.kernel_launches) == before


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_delta_is_the_f32_row_dot_and_leaves_its_inputs_alone(dtype):
    g = torch.Generator().manual_seed(1)
    do, out = (torch.randn(1, 2, 70, 64, generator=g).to(dtype) for _ in range(2))
    keep = do.clone(), out.clone()
    delta = fa.flash_delta(do, out)
    assert delta.dtype == F32 and delta.shape == (1, 2, 70) and delta.is_contiguous()
    assert torch.equal(delta, (do.float() * out.float()).sum(-1))
    assert torch.equal(do, keep[0]) and torch.equal(out, keep[1])
