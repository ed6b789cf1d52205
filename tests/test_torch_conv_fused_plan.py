"""The launch plan of B8, the small-channel 3x3 conv + bias (+ ReLU)
(``conv_fused.conv3x3_fused_plan``): a pure function of dtype, shape and
x's alignment that the wrapper passes to csrc/conv_fused.cu (the slab
kernel) or csrc/conv3x3.cu (mma.sync, simt), so the CPU can pin which
kernel each call takes, how a band of R rows is laid out in shared memory
and how many resident blocks walk the bands.
"""

import pytest
import torch

from kurosiwo_torch.ops import conv_fused
from kurosiwo_torch.ops.conv_fused import FusedPlan, conv3x3_fused_plan, slab_smem

BF16, F32 = torch.bfloat16, torch.float32
MAIN = [(128, 224, 224, 16, 16), (128, 112, 112, 32, 32)]
# shapes the slab kernel takes: the main ones, ragged bands and widths, the
# box edge W = 254, Cin and Cout of 48 and 64, more bands than a grid
SLAB_SHAPES = MAIN + [(3, 21, 37, 32, 16), (1, 10, 254, 16, 16), (2, 9, 10, 48, 48),
                      (2, 9, 10, 64, 64), (2, 9, 30, 16, 64), (1, 5, 7, 16, 16),
                      (64, 50, 60, 32, 16), (1, 1, 1, 16, 16), (4, 17, 100, 64, 32)]


def plan(shape, dtype=BF16, aligned=True, sms=conv_fused.SMS):
    return conv3x3_fused_plan(dtype, *shape, aligned, sms)


@pytest.mark.parametrize("shape,smem", [(MAIN[0], 209984), (MAIN[1], 226368)])
def test_main_shapes_take_the_slab_kernel(shape, smem):
    """Bands of 8 rows, one block on each of the 132 SMs. Shared bytes by hand:
    224^2 x 16 has 10 x 226 x 32-byte slab rows (72,320, rounded to 72,704)
    twice, two 4 x 224 x 32-byte half-band output tiles (28,672 each), 3
    K-major weight tiles of 16 x 128 bytes, 8 mbarriers and 1 KB of slack."""
    assert plan(shape) == FusedPlan("slab", 8, smem, 132)
    assert slab_smem(224, 16, 16, 8) == 2 * 72704 + 2 * 28672 + 3 * 16 * 128 + 64 + 1024


@pytest.mark.parametrize("shape,why", [
    ((2, 9, 10, 40, 24), "Cin 40, Cout 24: no multiple of 16"),
    ((2, 9, 10, 16, 24), "Cout 24"),
    ((2, 9, 10, 80, 16), "Cin 80: past 64"),
    ((2, 8, 255, 16, 16), "W + 2 = 257: past TMA's 256-pixel box"),
    ((2, 9, 254, 64, 64), "W 254 at Cin 64: no band fits shared memory"),
    ((2, 14, 14, 256, 256), "B6's channels"),
])
def test_bf16_calls_the_slab_kernel_does_not_take_go_to_mma_sync(shape, why):
    b, h, w, _, _ = shape
    assert plan(shape) == FusedPlan("mma_sync", 0, 0, -(-b * h * w // 128)), why


@pytest.mark.parametrize("shape", MAIN)
def test_a_misaligned_view_goes_to_mma_sync(shape):
    """TMA reads x from a 16-byte boundary: a view off it takes mma.sync."""
    assert plan(shape, aligned=False).kernel == "mma_sync"


@pytest.mark.parametrize("shape", MAIN + [(2, 9, 10, 40, 24), (1, 3, 300, 16, 16)])
def test_f32_takes_the_cuda_core_kernel(shape):
    b, h, w, _, _ = shape
    for aligned in (True, False):
        assert plan(shape, F32, aligned) == FusedPlan("simt", 0, 0, -(-b * h * w // 64))


def test_no_kernel_takes_half():
    with pytest.raises(TypeError, match="float16"):
        plan(MAIN[0], torch.float16)


@pytest.mark.parametrize("shape", SLAB_SHAPES)
def test_slab_layout_fits_a_block(shape):
    """The layout is within the 227 KB one block may take, R even (two half
    bands) and within TMA's box, and the plan's bytes are the layout's, with
    two halo slabs in flight."""
    _, h, w, cin, cout = shape
    p = plan(shape)
    assert p.kernel == "slab" and conv_fused.SLABS == 2
    assert p.rows % 2 == 0 and 2 <= p.rows <= 8 and p.rows + 2 <= 256 and w + 2 <= 256
    assert p.smem == slab_smem(w, cin, cout, p.rows) <= 232448


@pytest.mark.parametrize("shape", SLAB_SHAPES)
def test_bands_cover_every_image_exactly(shape):
    """ceil(H / R) bands of R rows cover H: the last may be ragged (TMA
    reads its rows past H as 0 and the stores clip them), but no band lies
    wholly past H, and R is no taller than H rounded up to even."""
    _, h, _, _, _ = shape
    p = plan(shape)
    bands = -(-h // p.rows)
    starts = [i * p.rows for i in range(bands)]
    covered = {r for s in starts for r in range(s, min(s + p.rows, h))}
    assert covered == set(range(h)) and starts[-1] < h <= starts[-1] + p.rows
    assert p.rows <= max(2, h + h % 2)


def test_the_ragged_shape_has_a_short_last_band_and_tiles_across_rows():
    """(3, 21, 37): bands of 8 rows end in one of 5; a half band is 4 x 37 =
    148 pixels, no multiple of 64, so m64 tiles cross output rows."""
    p = plan((3, 21, 37, 32, 16))
    assert p.rows == 8 and 21 % p.rows == 5 and (p.rows // 2 * 37) % 64
    assert p.grid == 3 * 3  # one block a band: fewer bands than SMs


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("shape", SLAB_SHAPES)
def test_grid_is_at_most_the_resident_blocks(shape, sms):
    """One block on each of ``sms`` SMs, no more than one a band (the card
    tests hold one block an SM to the kernel's own occupancy)."""
    b, h, _, _, _ = shape
    p = plan(shape, sms=sms)
    assert 1 <= p.grid == min(b * -(-h // p.rows), sms)


def test_more_bands_than_the_grid_wrap():
    """At the main shapes each resident block walks 27 or 28 (224^2) and
    13 or 14 (112^2) bands."""
    for shape, lo in zip(MAIN, (27, 13)):
        b, h, _, _, _ = shape
        p = plan(shape)
        assert b * -(-h // p.rows) // p.grid == lo


def test_plan_is_cached_and_pure():
    assert plan(MAIN[0]) is plan(MAIN[0])
    assert conv3x3_fused_plan.cache_info().hits >= 1
