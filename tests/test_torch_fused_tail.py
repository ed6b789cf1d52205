"""Port parity: kurosiwo_torch.ops.fused_tail against
kurosiwo_tpu.ops.pallas_tail (fused_ce_cm and fused_ce_cm_phase, Pallas in
interpret mode): loss, confusion matrix and gradient.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernel is held against them on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py).

Tolerances as the JAX package's own tail tests: loss rtol 2e-5 (2e-3 in
bf16), cm exact, gradient atol 1e-6 (2e-3 in bf16, one bf16 rounding of
values computed in f32 by both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.ops import fused_tail as tft
from kurosiwo_torch.ops.phase import depth_to_space, space_to_depth, space_to_depth_mask
from kurosiwo_tpu.ops import pallas_tail
from kurosiwo_tpu.ops import phase as jphase

torch.set_num_threads(2)

CW = [0.3715753140309927, 14.009780283125977, 8.20405370357821]
ONES = [1.0, 1.0, 1.0]


def _data(shape, seed, ties=False, all_ignored=False):
    rs = np.random.RandomState(seed)
    b, h, w, c = shape
    logits = np.zeros(shape, np.float32) if ties else rs.randn(*shape).astype(np.float32)
    labels = rs.randint(0, 4, (b, h, w) if c == 3 else (b, 2 * h, 2 * w)).astype(np.int32)
    if all_ignored:
        labels[:] = 3
    return logits, labels


def _run_both(logits, labels, cw, dtype, phase):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jl = jnp.asarray(logits, jdt)
    jlab = jnp.asarray(labels)
    jcw = jnp.asarray(cw, jnp.float32)
    jfn = pallas_tail.fused_ce_cm_phase if phase else pallas_tail.fused_ce_cm
    jloss, jcm = jfn(jl, jlab, jcw, True)
    jgrad = jax.grad(lambda x: jfn(x, jlab, jcw, True)[0] * 3.0)(jl)
    tl = torch.from_numpy(logits).to(tdt).requires_grad_(True)
    tfn = tft.fused_ce_cm_phase if phase else tft.fused_ce_cm
    tloss, tcm = tfn(tl, torch.from_numpy(labels), cw)
    (tloss * 3.0).backward()
    return (float(jloss), np.asarray(jcm), np.asarray(jgrad.astype(jnp.float32)),
            float(tloss.detach()), tcm.numpy(), tl.grad.float().numpy(), tl.grad.dtype == tdt)


CASES = {
    "basic": dict(shape=(2, 16, 16, 3)),
    "ragged": dict(shape=(1, 12, 10, 3)),
    "ties": dict(shape=(1, 16, 16, 3), ties=True),
    "all_ignored": dict(shape=(1, 8, 8, 3), all_ignored=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_ce_cm_matches_pallas(case, weighted, dtype):
    spec = CASES[case]
    logits, labels = _data(spec["shape"], seed=len(case), ties=spec.get("ties", False),
                           all_ignored=spec.get("all_ignored", False))
    jl, jcm, jg, tl, tcm, tg, same_dtype = _run_both(
        logits, labels, CW if weighted else ONES, dtype, phase=False)
    assert same_dtype
    np.testing.assert_allclose(tl, jl, rtol=2e-5 if dtype == "f32" else 2e-3)
    np.testing.assert_array_equal(tcm.astype(np.int64), jcm.astype(np.int64))
    np.testing.assert_allclose(tg, jg, atol=1e-6 if dtype == "f32" else 2e-3)
    if case == "all_ignored":
        assert tl == 0.0 and tcm.sum() == 0 and not tg.any()


PHASE_CASES = {
    "basic": dict(shape=(2, 8, 8, 12)),
    "ragged": dict(shape=(1, 6, 5, 12)),
    "ties": dict(shape=(1, 8, 8, 12), ties=True),
}


@pytest.mark.parametrize("case", sorted(PHASE_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_ce_cm_phase_matches_pallas(case, dtype):
    spec = PHASE_CASES[case]
    logits, labels = _data(spec["shape"], seed=7 + len(case), ties=spec.get("ties", False))
    jl, jcm, jg, tl, tcm, tg, same_dtype = _run_both(logits, labels, CW, dtype, phase=True)
    assert same_dtype
    np.testing.assert_allclose(tl, jl, rtol=2e-5 if dtype == "f32" else 2e-3)
    np.testing.assert_array_equal(tcm.astype(np.int64), jcm.astype(np.int64))
    np.testing.assert_allclose(tg, jg, atol=1e-6 if dtype == "f32" else 2e-3)


def test_phase_layout_matches_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 6, 5).astype(np.float32)
    m = rs.randint(0, 4, (2, 8, 6)).astype(np.int32)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jphase.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(space_to_depth_mask(torch.from_numpy(m)).numpy(),
                                  np.asarray(jphase.space_to_depth_mask(jnp.asarray(m))))
    z = rs.randn(2, 4, 3, 20).astype(np.float32)
    np.testing.assert_array_equal(depth_to_space(torch.from_numpy(z)).numpy(),
                                  np.asarray(jphase.depth_to_space(jnp.asarray(z))))


def test_phase_and_nhwc_agree_on_the_same_function():
    logits, labels = _data((2, 8, 8, 12), seed=11)
    z = torch.from_numpy(logits)
    lab = torch.from_numpy(labels)
    lp, cmp, _ = tft.ce_cm_phase_forward_plain(z, lab, torch.tensor(CW))
    ln, cmn, _ = tft.ce_cm_forward_plain(depth_to_space(z), lab, torch.tensor(CW))
    assert float(lp) == float(ln)
    assert torch.equal(cmp, cmn)


def test_resolve_fused_tail_rules():
    base = {"method": "unet", "loss_function": "cross_entropy", "num_classes": 3}
    assert tft.resolve_fused_tail(base, device="cuda") is True
    assert tft.resolve_fused_tail(base, device="cpu") is None
    assert tft.resolve_fused_tail(base) is None
    assert tft.resolve_fused_tail({**base, "fused_tail": False}, device="cuda") is None
    assert tft.resolve_fused_tail({**base, "fused_tail": True}, device="cpu") is True
    assert tft.resolve_fused_tail(base, task="cd", device="cuda") is None
    assert tft.resolve_fused_tail({**base, "method": "snunet"}, device="cuda") is None
    assert tft.resolve_fused_tail({**base, "num_classes": 2}, device="cuda") is None
    assert tft.resolve_fused_tail({**base, "log_zone_metrics": True}, device="cuda") is None
    with pytest.raises(ValueError, match="phase-space UNet head"):
        tft.resolve_fused_tail({**base, "fused_tail": "phase"})
    assert tft.resolve_fused_tail({**base, "fused_tail": "phase"}, strict=False) == "phase"
    with pytest.raises(ValueError, match="multi_scale_train"):
        tft.resolve_fused_tail({**base, "fused_tail": True},
                               model_config={"multi_scale_train": True})


def test_counters_do_not_move_on_cpu():
    before = (tft.ce_cm_fwd_nhwc.launches, tft.ce_cm_bwd_nhwc.launches)
    logits, labels = _data((1, 4, 4, 3), seed=2)
    tl = torch.from_numpy(logits).requires_grad_(True)
    tft.fused_ce_cm(tl, torch.from_numpy(labels), CW)[0].backward()
    assert (tft.ce_cm_fwd_nhwc.launches, tft.ce_cm_bwd_nhwc.launches) == before
