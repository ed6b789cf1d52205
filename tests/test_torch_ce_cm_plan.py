"""The launch plan of the CE + confusion-matrix kernels (``fused_tail.
ce_cm_plan``, B1 and B2): a pure function of the call's pixel count, shape,
layout, dtype and pointer alignment that the wrappers pass to csrc/ce_cm.cu,
so the CPU can pin which unit each call takes (16-byte words of 8 pixels or
4 phase cells, or one pixel) and what is left to the tail. The card tests
(tests/test_torch_cuda_kernels.py) hold the built kernels to the plan and
show that the entry points refuse a unit that does not fit.
"""

import pytest
import torch

from kurosiwo_torch.ops import fused_tail as ft

BF16, F32 = torch.bfloat16, torch.float32
NHWC, PHASE = ft.NHWC, ft.PHASE


def _plan(b, h, w, layout, dtype, align=16):
    return ft.ce_cm_plan(b * h * w, h, w, layout, dtype, align)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("layout", [NHWC, PHASE])
def test_main_shape_takes_the_vector_unit(layout, dtype):
    """The UNet b128 224x224 tail: 8 pixels a unit in NHWC, 4 phase cells
    (16 pixels) in PHASE, nothing left over."""
    plan = _plan(128, 224, 224, layout, dtype)
    unit = 8 if layout == NHWC else 16
    assert plan == ft.CECMPlan("vector", unit, 128 * 224 * 224 // unit, 0)


# (name, (B, H, W), layout, plan): the odd shapes of the card and CPU tests.
# PHASE's vector unit needs W % 8 == 0 (W/2 % 4 == 0); NHWC's takes any n >=
# 8 and leaves n mod 8 pixels to the tail
ODD = [
    ("card test PHASE", (3, 18, 22), PHASE, ("scalar", 1, 1188, 0)),
    ("CPU test PHASE", (1, 12, 10), PHASE, ("scalar", 1, 120, 0)),
    ("W/2 odd", (2, 8, 6), PHASE, ("scalar", 1, 96, 0)),
    ("card test NHWC", (3, 18, 22), NHWC, ("vector", 8, 148, 4)),
    ("CPU test NHWC", (1, 12, 10), NHWC, ("vector", 8, 15, 0)),
    ("n 7 NHWC", (1, 1, 7), NHWC, ("scalar", 1, 7, 0)),
    ("n 4 PHASE", (1, 2, 2), PHASE, ("scalar", 1, 4, 0)),
    ("W 8 PHASE", (1, 2, 8), PHASE, ("vector", 16, 1, 0)),
]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("name,shape,layout,want", ODD, ids=[o[0] for o in ODD])
def test_odd_shapes_take_their_unit(name, shape, layout, want, dtype):
    plan = _plan(*shape, layout, dtype)
    assert plan == ft.CECMPlan(*want)
    assert plan.units * plan.unit + plan.tail == shape[0] * shape[1] * shape[2]
    assert plan.tail < plan.unit or plan.tail == 0


@pytest.mark.parametrize("align", [2, 4, 8])
@pytest.mark.parametrize("layout", [NHWC, PHASE])
def test_a_misaligned_pointer_takes_the_scalar_unit(layout, align):
    plan = _plan(128, 224, 224, layout, BF16, align)
    assert plan == ft.CECMPlan("scalar", 1, 128 * 224 * 224, 0)


def test_alignment_of_tensors():
    buf = torch.zeros(64, dtype=BF16)
    assert ft.alignment(buf) == 16  # torch's allocations are 64-byte aligned
    assert ft.alignment(buf[1:]) == 2
    assert ft.alignment(buf[4:], buf) == 8
    assert ft.alignment(buf[8:], buf) == 16


def test_plan_is_cached_and_refuses_what_no_kernel_takes():
    assert _plan(128, 224, 224, NHWC, BF16) is _plan(128, 224, 224, NHWC, BF16)
    with pytest.raises(TypeError):
        _plan(1, 8, 8, NHWC, torch.float16)
    with pytest.raises(ValueError, match="layout 2"):
        _plan(1, 8, 8, 2, F32)
    with pytest.raises(ValueError):
        _plan(1, 7, 8, PHASE, F32)  # odd H has no phase layout
    with pytest.raises(ValueError):
        ft.ce_cm_plan(0, 8, 8, NHWC, F32, 16)
    with pytest.raises(ValueError):
        ft.ce_cm_plan(65, 8, 8, NHWC, F32, 16)  # n is not B*H*W


def test_wrappers_count_launches_by_plan_kernel():
    for fn in (ft.ce_cm_fwd_nhwc, ft.ce_cm_bwd_nhwc, ft.ce_cm_fwd_phase, ft.ce_cm_bwd_phase):
        assert set(fn.kernel_launches) == set(ft.CE_CM_KERNELS) == {"scalar", "vector"}
        assert isinstance(fn.launches, int)


@pytest.mark.parametrize("layout", [NHWC, PHASE])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(layout):
    g = torch.Generator().manual_seed(0)
    b, h, w = 2, 8, 16
    shape = (b, h, w, 3) if layout == NHWC else (b, h // 2, w // 2, 12)
    logits = torch.randn(shape, generator=g)
    labels = torch.randint(0, 4, (b, h, w), generator=g, dtype=torch.int32)
    cw = torch.tensor([0.5, 2.0, 3.0])
    gs = torch.tensor([0.25])
    fwd = ft.ce_cm_fwd_nhwc if layout == NHWC else ft.ce_cm_fwd_phase
    bwd = ft.ce_cm_bwd_nhwc if layout == NHWC else ft.ce_cm_bwd_phase
    plain_f = ft.ce_cm_forward_plain if layout == NHWC else ft.ce_cm_phase_forward_plain
    plain_b = ft.ce_cm_backward_plain if layout == NHWC else ft.ce_cm_phase_backward_plain
    counts = [(fn.launches, dict(fn.kernel_launches)) for fn in (fwd, bwd)]
    assert all(torch.equal(a, r) for a, r in zip(fwd(logits, labels, cw),
                                                  plain_f(logits, labels, cw)))
    assert torch.equal(bwd(logits, labels, cw, gs), plain_b(logits, labels, cw, gs))
    assert [(fn.launches, fn.kernel_launches) for fn in (fwd, bwd)] == counts
