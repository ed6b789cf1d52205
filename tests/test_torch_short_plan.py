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
from kurosiwo_torch.ops.attention import _flash_route, _short_route

BF16, F32 = torch.bfloat16, torch.float32

# (name, dtype, D, Nq, Nk, kernel): the MAE ViT-L b64 encoder (49 kept
# tokens) and decoder (196), chip_smoke.py's small MAE (13 kept of 49, and
# its 50-token decoder with the cls token), a ragged Nq != Nk shape, D 128,
# the long queries over at most 64 keys that the wgmma_long kernels take
# (Nq > 256, D 64), and the calls neither takes
PLANS = [
    ("MAE encoder", BF16, 64, 49, 49, "wgmma"),
    ("MAE decoder", BF16, 64, 196, 196, "wgmma"),
    ("finetune ViT-L", BF16, 64, 197, 197, "wgmma"),
    ("small MAE encoder", BF16, 64, 13, 13, "wgmma"),
    ("small MAE decoder", BF16, 64, 50, 50, "wgmma"),
    ("ragged D64", BF16, 64, 200, 130, "wgmma"),
    ("D128", BF16, 128, 77, 120, "wgmma"),
    ("N 3136", BF16, 64, 3136, 3136, "mma_sync"),
    ("Nq 257", BF16, 64, 257, 49, "wgmma_long"),
    ("Nq 257 Nk 64", BF16, 64, 257, 64, "wgmma_long"),
    ("Nq 257 Nk 1", BF16, 64, 257, 1, "wgmma_long"),
    ("Nq 300 Nk 65", BF16, 64, 300, 65, "mma_sync"),
    ("D128 long head", BF16, 128, 3136, 4, "mma_sync"),
    ("D32 long head", BF16, 32, 3136, 4, "mma_sync"),
    ("f32 Nq 257 Nk 64", F32, 64, 257, 64, "simt"),
    ("D128 Nk 129", BF16, 128, 64, 129, "mma_sync"),
    ("D32", BF16, 32, 77, 77, "mma_sync"),
    ("f32 encoder", F32, 64, 49, 49, "simt"),
    ("f32 D128", F32, 128, 200, 130, "simt"),
    # the change-detection calls that take B4 (A6_SHAPES below), in bf16 and f32
    ("ChangeFormer stage 2", BF16, 64, 784, 49, "wgmma_long"),
    ("BiT decoder", BF16, 64, 3136, 4, "wgmma_long"),
    ("ChangeFormer stage 4", BF16, 64, 49, 49, "wgmma"),
    ("BiT encoder", BF16, 64, 8, 8, "wgmma"),
    ("f32 ChangeFormer stage 2", F32, 64, 784, 49, "simt"),
    ("f32 BiT decoder", F32, 64, 3136, 4, "simt"),
]

# (name, Nq, Nk, heads, D, takes B4) of every attention call of the
# change-detection models at 224x224: ChangeFormer's four stages (spatial
# reduction 8, 4, 2, 1 to 7x7 keys), BiT's token encoder and its decoder
# (pixels of the 56x56 map against 4 tokens; dim_head 64, or 8 in
# ..._dedim8) and TransUNet's ViT (196 tokens and the cls token, 4 heads
# of 256)
A6_SHAPES = [
    ("ChangeFormer stage 1", 3136, 49, 1, 64, False),   # H*D 64
    ("ChangeFormer stage 2", 784, 49, 2, 64, True),
    ("ChangeFormer stage 3", 196, 49, 4, 80, False),    # D 80
    ("ChangeFormer stage 4", 49, 49, 8, 64, True),
    ("BiT encoder", 8, 8, 8, 64, True),
    ("BiT decoder", 3136, 4, 8, 64, True),
    ("BiT decoder dedim8", 3136, 4, 8, 8, False),       # D 8
    ("TransUNet ViT", 197, 197, 4, 256, False),          # D 256
]


@pytest.mark.parametrize("name,dtype,d,nq,nk,kernel", PLANS, ids=[p[0] for p in PLANS])
def test_each_call_takes_its_kernel(name, dtype, d, nq, nk, kernel):
    plan = sa.short_plan(dtype, d, nq, nk)
    assert plan.kernel == kernel and plan.kernel in sa.SHORT_KERNELS
    if dtype == BF16:
        assert sa.wgmma_takes(d, nq, nk) == (kernel == "wgmma")
        assert sa.long_route(d, nq, nk) == (kernel == "wgmma_long")
    assert not _flash_route(nq, nk)  # every one of these reaches the short route


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("nk", [1, 49, 64, 65, 128, 129, 196, 256])
def test_every_wgmma_plans_shared_memory_fits_a_block(d, nk):
    for nq in range(1, 257, 5):
        if not sa.wgmma_takes(d, nq, nk):
            continue
        assert 0 < sa.wgmma_fwd_smem(d, nq, nk) <= sa.SMEM_LIMIT == 227 * 1024
        assert 0 < sa.wgmma_bwd_smem(d, nk) <= sa.SMEM_LIMIT


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_every_long_plans_shared_memory_fits_an_sm(which):
    """Every wgmma_long plan (Nk 1-64, Nq 257-4,096) fits one block, and
    the blocks ``long_chunk`` counts on fit one SM's 228 KB (1 KB of each
    block's reserved): four forward blocks, three backward ones up to 32
    keys, else two."""
    for nk in range(1, 65):
        for nq in range(257, 4097, 61):
            plan = sa.short_plan(BF16, 64, nq, nk)
            assert plan.kernel == "wgmma_long" and plan.fwd_threads == plan.bwd_threads == 128
            smem = plan.fwd_smem if which == "fwd" else plan.bwd_smem
            assert 0 < smem <= sa.SMEM_LIMIT
            assert sa.long_blocks(which, nk) * (smem + 1024) <= 228 * 1024
    assert sa.long_fwd_smem() == 6 * 8192 + 32 + 1024
    assert [sa.long_bwd_smem(nk) for nk in (4, 49)] == [8 * 8192 + 2 * 16 * 128 + 24 + 1024,
                                                         8 * 8192 + 2 * 64 * 128 + 24 + 1024]
    assert [sa.long_blocks(which, nk) for nk in (1, 16, 17, 32, 33, 64)] == (
        [4] * 6 if which == "fwd" else [3, 3, 3, 3, 2, 2])


# (which, Nq, Nk, items = B * H, tiles a unit): BiT-CD dd8's decoder at b128
# (1,024 items of 49 query tiles: the forward cuts each in two, the backward
# takes whole items), ChangeFormer's stage 2 (256 items of 13 tiles), a
# small batch (every item cut to single tiles) and a ragged edge
LONG_CHUNKS = [("fwd", 3136, 4, 1024, 25), ("bwd", 3136, 4, 1024, 49),
               ("fwd", 784, 49, 256, 3), ("bwd", 784, 49, 256, 5),
               ("fwd", 1000, 49, 4, 1), ("bwd", 257, 1, 2, 1), ("bwd", 4096, 64, 8, 1)]


@pytest.mark.parametrize("which,nq,nk,items,chunk", LONG_CHUNKS,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-{c[3]}" for c in LONG_CHUNKS])
def test_long_chunks_cover_each_query_tile_once(which, nq, nk, items, chunk):
    """``long_chunk`` cuts each item's query tiles into chunks that cover
    each tile exactly once, in order (unit item * chunks + c, whose dK and
    dV partials the backward sums in c order), and gives every resident
    block LONG_WAVES units where the items' tiles allow."""
    got = sa.long_chunk(which, nq, nk, items)
    assert got == chunk == sa.long_chunk(which, nq, nk, items)
    nqt = -(-nq // 64)
    chunks = -(-nqt // chunk)
    tiles = [t for c in range(chunks) for t in range(c * chunk, min((c + 1) * chunk, nqt))]
    assert tiles == list(range(nqt))
    assert all(c * chunk < nqt for c in range(chunks))  # no empty unit
    resident = sa.SMS * sa.long_blocks(which, nk)
    assert items * chunks >= min(items * nqt, sa.LONG_WAVES * resident)


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


@pytest.mark.parametrize("name,nq,nk,heads,d,short", A6_SHAPES, ids=[s[0] for s in A6_SHAPES])
def test_change_detection_shapes_route_as_jax(monkeypatch, name, nq, nk, heads, d, short):
    """The port's router sends each change-detection attention shape where
    the JAX package sends it on the TPU: its attention_packed, traced with
    the short kernel's gate open (kurosiwo_tpu/ops/attention.py:121-125),
    calls short_attention exactly for the shapes that take B4 in the port."""
    import jax
    import jax.numpy as jnp

    from kurosiwo_tpu.ops import attention as jattn
    from kurosiwo_tpu.ops import pallas_attention as jpa

    calls = []
    monkeypatch.setattr(jattn, "_use_short_kernel", lambda: True)
    monkeypatch.setattr(jpa, "short_attention", lambda q, k, v, h, s: calls.append(1) or q)
    q = jax.ShapeDtypeStruct((1, nq, heads * d), jnp.bfloat16)
    kv = jax.ShapeDtypeStruct((1, nk, heads * d), jnp.bfloat16)
    jax.eval_shape(lambda a, b, c: jattn.attention_packed(a, b, c, heads), q, kv, kv)
    assert bool(calls) == short
    assert _short_route(nq, nk, d, heads * d) == short


def test_finetuner_attention_routes_as_jax(monkeypatch):
    """The FloodViT finetuner's encoder (ViT-L widths: dim 1024, 16 heads of
    64, 197 tokens at 224x224, depth cut to 2): the JAX model, traced with
    the short kernel's gate open, calls short_attention in every layer, and
    the port's router sends (197, 197, D 64, H*D 1024) to B4, whose plan
    takes it on the wgmma kernels in bf16."""
    import jax
    import jax.numpy as jnp

    from kurosiwo_tpu.models.finetuner import FinetunerSegmentation
    from kurosiwo_tpu.models.vit import ViT
    from kurosiwo_tpu.ops import attention as jattn
    from kurosiwo_tpu.ops import pallas_attention as jpa

    calls = []
    monkeypatch.setattr(jattn, "_use_short_kernel", lambda: True)
    monkeypatch.setattr(jpa, "short_attention",
                        lambda q, k, v, h, s: calls.append((q.shape, h)) or q)
    vit = ViT(image_size=224, patch_size=16, dim=1024, depth=2, heads=16, mlp_dim=2048,
              channels=6, pool="cls", dtype=jnp.bfloat16)
    model = FinetunerSegmentation(vit, 3, "mlp", 16, 224, dtype=jnp.bfloat16)
    x = jax.ShapeDtypeStruct((1, 224, 224, 6), jnp.float32)
    jax.eval_shape(lambda x: model.init_with_output(jax.random.PRNGKey(0), x), x)
    assert calls and all(c == ((1, 197, 1024), 16) for c in calls) and len(calls) % 2 == 0
    assert _short_route(197, 197, 64, 1024)
    assert sa.short_plan(BF16, 64, 197, 197).kernel == "wgmma"
