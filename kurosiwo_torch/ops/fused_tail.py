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

Loss math is ``ops/losses.cross_entropy_loss`` (f32 logsumexp on upcast
logits, torch's weight-sum denominator clamped at 1e-12); the cm is
``ops/metrics.confusion_matrix`` of the first-max argmax, as f32 counts
(exact below 2^24). Gradients flow to the logits only: the cm feeds the
metric bank and the class weights are constants.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .phase import depth_to_space, space_to_depth

IGNORE_INDEX = 3
NHWC, PHASE = 0, 1
_TARGET_BLOCKS = 132 * 8
_THREADS = 256


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
# kernel launches

def _lib():
    import ctypes

    lib = kernels.library("ce_cm")
    if lib.ks_ce_cm_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ks_ce_cm_fwd.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, i, p]
        lib.ks_ce_cm_fwd.restype = i
        lib.ks_ce_cm_bwd.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, p]
        lib.ks_ce_cm_bwd.restype = i
    return lib


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
    return n, h, w, max(1, min(_TARGET_BLOCKS, -(-n // _THREADS)))


def _forward_cuda(logits, labels, cw, layout):
    n, h, w, nblk = _check_inputs(logits, labels, cw, layout)
    dev = logits.device
    part_f = torch.empty((nblk, 2), dtype=torch.float32, device=dev)
    part_i = torch.empty((nblk, 9), dtype=torch.int32, device=dev)
    out = torch.empty((18,), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.ks_ce_cm_fwd(
        logits.data_ptr(), labels.data_ptr(), cw.data_ptr(), part_f.data_ptr(),
        part_i.data_ptr(), out.data_ptr(), n, h, w, layout,
        int(logits.dtype == torch.bfloat16), nblk, kernels.stream_ptr(logits),
    )
    kernels.check(lib, err, "ce_cm forward launch")
    return out[0], out[2:].reshape(4, 4), out[1]


def _backward_cuda(logits, labels, cw, gscale, layout):
    n, h, w, nblk = _check_inputs(logits, labels, cw, layout)
    if gscale.dtype != torch.float32 or gscale.numel() != 1 or gscale.device != logits.device:
        raise TypeError("ce_cm backward takes a one-element f32 gscale on the logits' device")
    d = torch.empty_like(logits)
    lib = _lib()
    err = lib.ks_ce_cm_bwd(
        logits.data_ptr(), labels.data_ptr(), cw.data_ptr(), gscale.data_ptr(), d.data_ptr(),
        n, h, w, layout, int(logits.dtype == torch.bfloat16), nblk, kernels.stream_ptr(logits),
    )
    kernels.check(lib, err, "ce_cm backward launch")
    return d


# ---------------------------------------------------------------------------
# counted wrappers: a CPU tensor takes the plain version, a CUDA tensor the
# kernel; `.launches` counts kernel launches (forward: the partials launch
# and its fixed-order reduce, counted as one)

def ce_cm_fwd_nhwc(logits, labels, cw):
    if logits.device.type == "cpu":
        return ce_cm_forward_plain(logits, labels, cw)
    out = _forward_cuda(logits, labels, cw, NHWC)
    ce_cm_fwd_nhwc.launches += 1
    return out


def ce_cm_bwd_nhwc(logits, labels, cw, gscale):
    if logits.device.type == "cpu":
        return ce_cm_backward_plain(logits, labels, cw, gscale)
    d = _backward_cuda(logits, labels, cw, gscale, NHWC)
    ce_cm_bwd_nhwc.launches += 1
    return d


def ce_cm_fwd_phase(z, labels, cw):
    if z.device.type == "cpu":
        return ce_cm_phase_forward_plain(z, labels, cw)
    out = _forward_cuda(z, labels, cw, PHASE)
    ce_cm_fwd_phase.launches += 1
    return out


def ce_cm_bwd_phase(z, labels, cw, gscale):
    if z.device.type == "cpu":
        return ce_cm_phase_backward_plain(z, labels, cw, gscale)
    d = _backward_cuda(z, labels, cw, gscale, PHASE)
    ce_cm_bwd_phase.launches += 1
    return d


for _f in (ce_cm_fwd_nhwc, ce_cm_bwd_nhwc, ce_cm_fwd_phase, ce_cm_bwd_phase):
    _f.launches = 0
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
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        blockers.append("requires a single CUDA device (the kernel's sums are not all-reduced)")
    return blockers


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
