"""Fused loss/metrics tail: class-weighted cross entropy (ignore index 3) and
the 4x4 confusion matrix in one pass over 3-class logits, with a fused
backward. The hand-written kernels are in ``csrc/ce_cm.cu``.

Counterpart of ``kurosiwo_tpu/ops/pallas_tail.py``:

* ``fused_ce_cm(logits (B,H,W,3), labels, cw)`` replaces ``fused_ce_cm``
  (TPU kernels ``_fwd_kernel`` / ``_bwd_kernel``), here the NHWC
  instantiation of the kernel; the port's train step launches it.
* ``fused_ce_cm_phase(z (B,H/2,W/2,12), labels, cw)`` replaces
  ``fused_ce_cm_phase`` (``_phase_fwd_kernel`` / ``_phase_bwd_kernel``), the
  PHASE instantiation over ``ops/phase.py``'s layout. No path of the port
  launches it yet: the port's UNet has no phase-space head.

On the card each call takes the unit that ``ce_cm_plan`` names: 16-byte
loads of 8 pixels (NHWC) or 4 phase cells (PHASE) where shape and pointers
allow, one pixel otherwise. The forward is one launch, its cross-block fold
included; the grid is every block the card holds at once.

Loss math is ``ops/losses.cross_entropy_loss`` (f32 logsumexp on upcast
logits, torch's weight-sum denominator clamped at 1e-12); the cm is
``ops/metrics.confusion_matrix`` of the first-max argmax, as f32 counts
(exact below 2^24). Gradients flow to the logits only: the cm feeds the
metric bank and the class weights are constants.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels
from .phase import depth_to_space, space_to_depth

IGNORE_INDEX = 3
NHWC, PHASE = 0, 1
# the units of csrc/ce_cm.cu, by their number there
CE_CM_KERNELS = {"scalar": 0, "vector": 1}
VECTOR_BYTES = 16  # the vector unit's loads and stores
_PARTS = 11  # a forward block's partials: num, den, 9 cm cells
_MAX_BLOCKS_PER_SM = 8  # 256-thread blocks an H100 SM holds at most (2048 threads)
_WORKSPACES: dict[tuple[int, int], torch.Tensor] = {}


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference on the card)

def ce_cm_forward_plain(logits: torch.Tensor, labels: torch.Tensor, cw: torch.Tensor):
    """(loss, cm (4,4) f32, total_w) from (B,H,W,3) logits."""
    x = logits.float().reshape(-1, 3)
    lab = labels.reshape(-1).long()
    valid = (lab >= 0) & (lab < 3)
    safe = torch.where(valid, lab, 0)
    lse = torch.logsumexp(x, dim=-1)
    picked = x.gather(1, safe[:, None])[:, 0]
    w = torch.where(valid, cw.float()[safe], 0.0)
    total_w = torch.clamp_min(w.sum(), 1e-12)
    loss = (w * (lse - picked)).sum() / total_w
    pred = torch.argmax(x, dim=-1)  # first maximum wins
    cell = torch.where(valid, safe * 4 + pred, 16)
    cm = torch.bincount(cell, minlength=17)[:16].float().reshape(4, 4)
    return loss, cm, total_w


def ce_cm_backward_plain(logits, labels, cw, gscale):
    """dlogits = gscale * w * (softmax - onehot), in the logits' dtype."""
    x = logits.float().reshape(-1, 3)
    lab = labels.reshape(-1).long()
    valid = (lab >= 0) & (lab < 3)
    safe = torch.where(valid, lab, 0)
    w = torch.where(valid, cw.float()[safe], 0.0)
    onehot = F.one_hot(safe, 3).float()
    d = gscale.reshape(()) * w[:, None] * (torch.softmax(x, dim=-1) - onehot)
    return d.to(logits.dtype).reshape(logits.shape)


def ce_cm_phase_forward_plain(z, labels, cw):
    return ce_cm_forward_plain(depth_to_space(z), labels, cw)


def ce_cm_phase_backward_plain(z, labels, cw, gscale):
    return space_to_depth(ce_cm_backward_plain(depth_to_space(z), labels, cw, gscale))


# ---------------------------------------------------------------------------
# the launch plan

class CECMPlan(NamedTuple):
    kernel: str  # the unit, a key of CE_CM_KERNELS
    unit: int    # pixels a thread takes at a time
    units: int   # whole units of the call
    tail: int    # pixels past the last whole unit, one a thread, in the same launch


@functools.lru_cache(maxsize=None)
def ce_cm_plan(n: int, h: int, w: int, layout: int, dtype: torch.dtype, align: int) -> CECMPlan:
    """The csrc/ce_cm.cu unit of a call over n = B*H*W labels, whose logits,
    labels (and dlogits) share ``align`` bytes of alignment. The vector unit
    reads 16-byte words: 8 consecutive pixels in NHWC (any n >= 8; the n mod
    8 last pixels are the tail), 4 consecutive phase cells (16 pixels of two
    label rows) in PHASE, which needs W % 8 == 0. Other calls take the same
    kernel with a unit of one pixel (element loads). The C entry points
    refuse a unit that does not fit the call (the wrapper raises)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ce_cm_plan: no kernel takes {dtype}")
    if layout not in (NHWC, PHASE) or min(n, h, w) < 1 or n % (h * w) \
            or (layout == PHASE and (h % 2 or w % 2)):
        raise ValueError(f"ce_cm_plan: no kernel takes n = {n}, H = {h}, W = {w}, "
                         f"layout {layout}")
    if align % VECTOR_BYTES or (n < 8 if layout == NHWC else w % 8):
        return CECMPlan("scalar", 1, n, 0)
    unit = 8 if layout == NHWC else 16
    return CECMPlan("vector", unit, n // unit, n % unit)


def alignment(*ts: torch.Tensor) -> int:
    """The tensors' common alignment in bytes, at most VECTOR_BYTES."""
    return min(min(t.data_ptr() & -t.data_ptr(), VECTOR_BYTES) for t in ts)


# ---------------------------------------------------------------------------
# kernel launches

def _lib():
    import ctypes

    lib = kernels.library("ce_cm")
    if lib.ks_ce_cm_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ks_ce_cm_fwd.argtypes = [p, p, p, p, i, p, ll, i, i, i, i, i, p]
        lib.ks_ce_cm_fwd.restype = i
        lib.ks_ce_cm_bwd.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, p]
        lib.ks_ce_cm_bwd.restype = i
        lib.ks_ce_cm_grid.argtypes = [i, i, i, i, ll, i, i, ip, ip, ip]
        lib.ks_ce_cm_grid.restype = i
    return lib


def ce_cm_grid(fwd: bool, layout: int, dtype: torch.dtype, plan: CECMPlan, n: int, h: int,
               w: int) -> tuple[int, int, int]:
    """(blocks, blocks one SM holds, registers a thread) of the built kernel
    that ``plan`` names, on the current card: the grid its launch takes."""
    import ctypes

    out = [ctypes.c_int(0) for _ in range(3)]
    lib = _lib()
    err = lib.ks_ce_cm_grid(int(fwd), layout, int(dtype == torch.bfloat16),
                            CE_CM_KERNELS[plan.kernel], n, h, w, *map(ctypes.byref, out))
    kernels.check(lib, err, "ce_cm grid")
    return tuple(v.value for v in out)


def _workspace(device: torch.device) -> torch.Tensor:
    """The forward's int32 workspace on the current stream: word 0 the
    ticket, then _PARTS words for each block the card can hold at once.
    Zeroed once; the last block of each launch sets the ticket back to 0, so
    the launches of one stream share it and another stream has its own."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        ws = torch.zeros(1 + _PARTS * _MAX_BLOCKS_PER_SM * sms, dtype=torch.int32, device=device)
        _WORKSPACES[key] = ws
    return ws


def _check_inputs(logits, labels, cw, layout):
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ce_cm kernel takes f32 or bf16 logits, got {logits.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"ce_cm kernel takes int32 labels, got {labels.dtype}")
    if cw.dtype != torch.float32 or cw.shape != (3,):
        raise TypeError(f"ce_cm kernel takes (3,) f32 class weights, got {cw.dtype} {tuple(cw.shape)}")
    if not (labels.device == logits.device == cw.device):
        raise ValueError("ce_cm: logits, labels and class weights must share one device")
    if not (logits.is_contiguous() and labels.is_contiguous() and cw.is_contiguous()):
        raise ValueError("ce_cm kernel needs contiguous logits, labels and class weights")
    b, h, w = labels.shape
    want = (b, h, w, 3) if layout == NHWC else (b, h // 2, w // 2, 12)
    if tuple(logits.shape) != want or (layout == PHASE and (h % 2 or w % 2)):
        raise ValueError(f"ce_cm: logits {tuple(logits.shape)} do not match labels {tuple(labels.shape)}")
    n = b * h * w
    if n == 0:
        raise ValueError("ce_cm: empty input")
    return n, h, w


def _forward_cuda(logits, labels, cw, layout):
    n, h, w = _check_inputs(logits, labels, cw, layout)
    plan = ce_cm_plan(n, h, w, layout, logits.dtype, alignment(logits, labels))
    ws = _workspace(logits.device)
    out = torch.empty((18,), dtype=torch.float32, device=logits.device)
    lib = _lib()
    err = lib.ks_ce_cm_fwd(
        logits.data_ptr(), labels.data_ptr(), cw.data_ptr(), ws.data_ptr(),
        (ws.numel() - 1) // _PARTS, out.data_ptr(), n, h, w, layout,
        int(logits.dtype == torch.bfloat16), CE_CM_KERNELS[plan.kernel],
        kernels.stream_ptr(logits),
    )
    kernels.check(lib, err, f"ce_cm forward {plan.kernel} launch")
    return (out[0], out[2:].reshape(4, 4), out[1]), plan


def _backward_cuda(logits, labels, cw, gscale, layout):
    n, h, w = _check_inputs(logits, labels, cw, layout)
    if gscale.dtype != torch.float32 or gscale.numel() != 1 or gscale.device != logits.device:
        raise TypeError("ce_cm backward takes a one-element f32 gscale on the logits' device")
    d = torch.empty_like(logits)
    plan = ce_cm_plan(n, h, w, layout, logits.dtype, alignment(logits, labels, d))
    lib = _lib()
    err = lib.ks_ce_cm_bwd(
        logits.data_ptr(), labels.data_ptr(), cw.data_ptr(), gscale.data_ptr(), d.data_ptr(),
        n, h, w, layout, int(logits.dtype == torch.bfloat16), CE_CM_KERNELS[plan.kernel],
        kernels.stream_ptr(logits),
    )
    kernels.check(lib, err, f"ce_cm backward {plan.kernel} launch")
    return d, plan


# ---------------------------------------------------------------------------
# counted wrappers: a CPU tensor takes the plain version, a CUDA tensor the
# kernel; `.launches` counts kernel launches (the forward is one launch, its
# fold included), `.kernel_launches` them by the plan's unit

def _counted(fn, plan):
    fn.launches += 1
    fn.kernel_launches[plan.kernel] += 1


def ce_cm_fwd_nhwc(logits, labels, cw):
    if logits.device.type == "cpu":
        return ce_cm_forward_plain(logits, labels, cw)
    out, plan = _forward_cuda(logits, labels, cw, NHWC)
    _counted(ce_cm_fwd_nhwc, plan)
    return out


def ce_cm_bwd_nhwc(logits, labels, cw, gscale):
    if logits.device.type == "cpu":
        return ce_cm_backward_plain(logits, labels, cw, gscale)
    d, plan = _backward_cuda(logits, labels, cw, gscale, NHWC)
    _counted(ce_cm_bwd_nhwc, plan)
    return d


def ce_cm_fwd_phase(z, labels, cw):
    if z.device.type == "cpu":
        return ce_cm_phase_forward_plain(z, labels, cw)
    out, plan = _forward_cuda(z, labels, cw, PHASE)
    _counted(ce_cm_fwd_phase, plan)
    return out


def ce_cm_bwd_phase(z, labels, cw, gscale):
    if z.device.type == "cpu":
        return ce_cm_phase_backward_plain(z, labels, cw, gscale)
    d, plan = _backward_cuda(z, labels, cw, gscale, PHASE)
    _counted(ce_cm_bwd_phase, plan)
    return d


for _f in (ce_cm_fwd_nhwc, ce_cm_bwd_nhwc, ce_cm_fwd_phase, ce_cm_bwd_phase):
    _f.launches = 0
    _f.kernel_launches = dict.fromkeys(CE_CM_KERNELS, 0)
del _f

_FWD = {NHWC: ce_cm_fwd_nhwc, PHASE: ce_cm_fwd_phase}
_BWD = {NHWC: ce_cm_bwd_nhwc, PHASE: ce_cm_bwd_phase}


class _FusedCECM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, cw, layout):
        loss, cm, total_w = _FWD[layout](logits, labels, cw)
        ctx.save_for_backward(logits, labels, cw, total_w)
        ctx.layout = layout
        ctx.mark_non_differentiable(cm)
        return loss, cm

    @staticmethod
    def backward(ctx, g_loss, _g_cm):
        logits, labels, cw, total_w = ctx.saved_tensors
        gscale = (g_loss.float() / total_w).reshape(1)  # stays on the device
        return _BWD[ctx.layout](logits, labels, cw, gscale), None, None, None


def _weights(class_weights, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(class_weights, dtype=torch.float32, device=like.device)


def fused_ce_cm(logits: torch.Tensor, labels: torch.Tensor, class_weights):
    """(loss, cm) from (B,H,W,3) logits and (B,H,W) labels; see module doc."""
    return _FusedCECM.apply(logits, labels, _weights(class_weights, logits), NHWC)


def fused_ce_cm_phase(z: torch.Tensor, labels: torch.Tensor, class_weights):
    """(loss, cm) from phase-space (B,H/2,W/2,12) logits against the
    full-resolution (B,H,W) labels; the gradient stays in phase layout."""
    return _FusedCECM.apply(z, labels, _weights(class_weights, z), PHASE)


def _fused_tail_blockers(config: dict, model_config: dict | None) -> list[str]:
    """Hard requirements of the fused kernels; any failure keeps the plain
    torch tail (ops/losses.py + ops/metrics.py)."""
    blockers = []
    if config.get("loss_function", "cross_entropy") != "cross_entropy":
        blockers.append("loss_function must be cross_entropy")
    if int(config.get("num_classes", 3)) != 3:
        blockers.append("num_classes must be 3")
    if (model_config or {}).get("multi_scale_train"):
        blockers.append("multi_scale_train deep supervision is unsupported")
    if config.get("log_zone_metrics"):
        blockers.append("log_zone_metrics needs per-zone cm banks")
    if _world_size() > 1:
        blockers.append("requires a single process: under data parallelism the step keeps the "
                        "plain tail, whose loss and banks are reduced over the data group, as "
                        "the JAX package keeps the XLA tail on more than one device")
    return blockers


def _world_size() -> int:
    from ..parallel.distributed import process_info

    return process_info()[1]


def resolve_fused_tail(config: dict, task: str = "segmentation",
                       model_config: dict | None = None, strict: bool = True,
                       device: torch.device | str | None = None):
    """The loss/metrics tail of a step: True (fused NHWC kernel) or None
    (plain torch tail). An explicit ``config["fused_tail"]`` wins; under
    ``strict`` an explicit but ineligible request raises, naming the
    blocker. "auto" turns the kernel on for the UNet segmentation step on
    one CUDA device. ``"phase"`` needs the phase-space head of the JAX UNet,
    which the port does not have, so it is a blocker."""
    flag = config.get("fused_tail", "auto")
    is_unet_seg = task == "segmentation" and str(config.get("method", "")).lower() == "unet"
    if flag != "auto":
        flag = flag or None
        if flag and not strict and _world_size() > 1:
            return None  # the eval step under data parallelism: the plain tail
        if flag and strict:
            blockers = _fused_tail_blockers(config, model_config)
            if flag == "phase":
                blockers.append('fused_tail="phase" needs the phase-space UNet head '
                                "(UNet.phase_finale), which the port does not implement")
            if blockers:
                raise ValueError(
                    f"config requests fused_tail={flag!r} but the fused CE+cm tail "
                    f"cannot apply: {'; '.join(blockers)}")
        return flag
    dev = torch.device(device) if device is not None else None
    if is_unet_seg and dev is not None and dev.type == "cuda" \
            and not _fused_tail_blockers(config, model_config):
        return True
    return None
