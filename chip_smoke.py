#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kurosiwo_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Each phase prints
its lines; any failed phase exits non-zero.

1. Device: the card's name and power limit (nvidia-smi) and torch's name.
2. Build: compile the hand-written kernels from kurosiwo_torch/csrc.
3. Kernels against their plain PyTorch versions at the main path's shapes
   (UNet-ResNet18, batch 128, 224x224): error within the stated band, two
   runs bitwise equal, and times (kernel, plain version, one library call)
   beside the bound of the card (3.35 TB/s HBM, 67 TFLOP/s f32 outside the
   tensor cores; H100 SXM data sheet).
   The CE + confusion-matrix kernels (B2 NHWC, B1 PHASE) at the main
   shape in f32 and bf16 on the unit their plan picked (the vector unit:
   16-byte words of 8 pixels or 4 phase cells), with its grid, blocks an SM
   and registers a thread; then a ragged (3, 18, 22) (NHWC's 4-pixel tail,
   PHASE's scalar unit), an all-ignore batch and a logits view off the
   16-byte grid (the scalar unit).
   The short-sequence attention kernels (B4), forward and backward, at the
   MAE ViT-L batch-64 shapes (encoder q/k/v (64, 49, 1024), decoder
   (64, 196, 1024), H 16, D 64) in f32 and bf16, and at a ragged D-32 and a
   ChangeFormer-sized (N 3136) shape, each with the kernel its plan picked
   (bf16 main shapes: the wgmma kernels), shared memory per block, blocks
   an SM and items per block; beside them the mma.sync kernels (the route
   of longer heads) on the same inputs, with their forward's error, and the
   backward as the MAE step runs it (into the thirds of one qkv gradient).
   The library yardstick is F.scaled_dot_product_attention on the (B, H, N, D) view and its autograd
   backward, from separate leaves and from one qkv leaf.
   The flash attention kernels (B5), forward, dq and dk/dv, at the
   whole-scene encode's shape (1, 16, 4096, 64) (q, k, v as head views of one
   qkv tensor, as the ViT passes them), at a ragged (2, 4, 1003 x 1090, 32)
   and at D 128, in f32 and bf16, each with the kernel its plan picked
   (bf16 at D 64 and 128: the wgmma kernels), shared memory per block and
   waves; the library yardstick is F.scaled_dot_product_attention and its
   autograd backward, beside the whole port backward (flash_delta, dq and
   dk/dv).
   The 3x3 conv kernels, in f32 and bf16: B6 (conv + BN statistics, with and
   without its prologue) at the train step's (128, 14, 14, 256)->256,
   (128, 7, 7, 512)->512 and (128, 14, 14, 768)->256, and at a ragged
   (3, 7, 7, 256)->256; B7 (weight gradient) at (128, 28, 28, 128)->128,
   (128, 28, 28, 384)->128 and a ragged (2, 9, 11, 128)->128; each with
   the kernel its wrapper's plan picked (bf16 routed calls: the wgmma
   kernels), its grid and TFLOP/s; B8 (bias + ReLU epilogue, no port path)
   at (128, 224, 224, 16)->16 and (128, 112, 112, 32)->32 and a ragged
   (3, 21, 37, 32)->16, bf16 on the slab kernel (TMA halo slabs, wgmma, TMA
   stores) beside the mma.sync kernel it replaced. Library yardsticks:
   F.conv2d (no statistics),
   torch.nn.grad.conv2d_weight, F.conv2d with bias and relu. Every device
   time is taken behind a sleep
   kernel, so the host's launch overhead does not stand in for a short
   kernel's time.
4. Slice parity: one f32 train step and one eval step of UNet-ResNet18 at
   (4, 64, 64, 6), default route and with the conv kernel routes on (B6 and
   B7 launched 8 and 5 times, their f32 kernels), and one f32 and one bf16
   MAE train step at a small size (B4 on its simt and wgmma kernels, 3 calls
   each way), on the card (kernels) against the same steps on the CPU
   (plain versions), same weights, batch and masking noise; the whole-scene
   ViT encode of a 512x512 scene (1,024 tokens, the flash route) at a small
   width with heads of 32 and of 64 (the wgmma forward), f32 and bf16, card
   against CPU.
5. Main paths at full width through kurosiwo_torch/bench.py's code: batch 128
   bf16 UNet train steps (3 warm-up, 10 timed), then the bf16 eval and the
   f32-twin eval, then the train step with the conv kernel routes on (the
   wgmma B6 8 times and the wgmma B7 5 times a step, by their own
   counters; every CE+cm launch of the three on the vector unit); then
   the MAE ViT-L batch-64 bf16 train step (3 warm-up, 10 timed; every B4
   call on the wgmma kernels, 32 each way a step); then
   serving: the ViT-L encode of a 1024x1024 scene (4,096 tokens; 3 warm-up,
   10 timed; 24 wgmma B5 forwards per encode, no other), a 1000x1000 scene
   (3,969 tokens, off the flash route) and the
   UNet-ResNet18 sliding-window map of a 2048x2048x6 scene (121 tiles of
   224, overlap 32, batch 32). Launch counters are zeroed before each and
   read after.
6. The kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense, tensor cores
SMS = 132  # streaming multiprocessors of an H100 SXM
BATCH = 128
IMAGE = 224
CW = [0.3715753140309927, 14.009780283125977, 8.20405370357821]
# (H, W, C) of every BatchNorm input of the UNet-ResNet18 step, with its
# count per forward pass (30 in all)
BN_SHAPES = [
    ((112, 112, 64), 1), ((56, 56, 64), 6), ((28, 28, 128), 7), ((14, 14, 256), 7),
    ((7, 7, 512), 5), ((112, 112, 32), 2), ((224, 224, 16), 2),
]


class PhaseFailed(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def host_ms(torch, fn, calls: int = 10) -> float:
    """Mean host time of one call, enqueued behind a busy card (no wait on
    the card inside): what the wrapper costs the host."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))  # about 0.1 s of device time, longer than the calls' host time
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e3


def event_ms(torch, fn, reps: int = 5, calls: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``calls`` back-to-back
    calls, from CUDA events, after a warm-up call. Each rep is queued behind
    a sleep kernel that outlasts the host's enqueueing of its calls, so a
    call whose host side takes longer than its kernels is timed by its
    kernels, not by the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # 2e9 cycles a second is above the card's clock, so the sleep lasts at
    # least twice the host time of the calls
    sleep_cycles = int(min(2 * calls * host_s + 1e-4, 0.2) * 2e9)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    return smi


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    per_source = kernels.build()
    total = time.perf_counter() - t0
    detail = ", ".join(f"{k}.cu {v:.1f}s" for k, v in sorted(per_source.items())) or "cached"
    print(f"[build] {total:.1f}s wall ({detail}) into {kernels.build_dir()}", flush=True)
    for name in ("pair_sums", "ce_cm", "short_attention", "flash_attention", "conv3x3",
                 "conv_dw", "conv_fused"):
        kernels.library(name)


def phase_pair_sums(torch, batchnorm) -> dict:
    """pair_sums at every BN shape of the step, f32 and bf16, (x, x) and
    (dy, x). Band: |kernel - plain| <= 1e-5 * sum of |terms| per channel
    (both sum the same f32 values in another order)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "flops": 0.0,
           "bytes": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0}
    for (h, w, c), count in BN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((BATCH, h, w, c), device=dev, generator=g).to(dtype)
            dy = torch.randn((BATCH, h, w, c), device=dev, generator=g).to(dtype)
            for a, b in ((x, x), (dy, x)):
                got = batchnorm.pair_sums(a, b)
                again = batchnorm.pair_sums(a, b)
                want = batchnorm.pair_sums_plain(a, b)
                af, bf = a.float().reshape(-1, c), b.float().reshape(-1, c)
                scale = torch.stack([af.abs().sum(0), (af * bf).abs().sum(0)])
                err = (got - want).abs()
                require(bool((err <= 1e-5 * scale + 1e-6).all()),
                        f"pair_sums {(BATCH, h, w, c)} {dtype}: error {err.max().item():.3e}")
                require(torch.equal(got, again), f"pair_sums {(BATCH, h, w, c)} not deterministic")
                tot["max_abs_err"] = max(tot["max_abs_err"], err.max().item())
                tot["max_rel_err"] = max(tot["max_rel_err"], (err / scale.clamp_min(1e-30)).max().item())
                if dtype != torch.bfloat16:
                    continue
                ms = event_ms(torch, lambda: batchnorm.pair_sums(a, b))
                plain = event_ms(torch, lambda: batchnorm.pair_sums_plain(a, b))
                lib = event_ms(torch, lambda: (torch.sum(a.view(-1, c), 0, dtype=torch.float32),
                                               torch.sum(a.view(-1, c) * b.view(-1, c), 0,
                                                         dtype=torch.float32)))
                nbytes = a.numel() * a.element_size() * (1 if a is b else 2) + 2 * c * 4
                flops = 3 * a.numel()
                bms, _ = bound(nbytes, flops)
                kind = "fwd (x,x)" if a is b else "bwd (dy,x)"
                print(f"[pair_sums] {(BATCH, h, w, c)} bf16 {kind} x{count}/step: kernel "
                      f"{ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
                      f"bound {bms * 1e3:.1f} us", flush=True)
                tot["ms"] += count * ms
                tot["plain_ms"] += count * plain
                tot["library_ms"] += count * lib
                tot["bytes"] += count * nbytes
                tot["flops"] += count * flops
            del x, dy
    tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["flops"])
    print(f"[pair_sums] per train step (30 fwd + 30 bwd calls, bf16): kernel {tot['ms']:.3f} ms, "
          f"plain {tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, "
          f"bound {tot['bound_ms']:.3f} ms ({tot['bytes'] / 1e9:.3f} GB)", flush=True)
    # sums over up to 6.4 M rows reach 1e6-1e7, where one f32 ulp is 0.06-1
    print(f"[pair_sums] max error: {tot['max_abs_err']:.3e} absolute, "
          f"{tot['max_rel_err']:.3e} of the sum of |terms|; deterministic", flush=True)
    return tot


# B1/B2's bf16 times at the main shape before the vector units (one pixel a
# thread, a second launch for the fold), recorded from an earlier run of
# this script on an NVIDIA H100 80GB HBM3 at 700 W; printed for reference,
# never measured here
EARLIER_CE_CM_MS = {"nhwc": {"fwd": 0.0498, "bwd": 0.0545},
                    "phase": {"fwd": 0.0760, "bwd": 0.0874}}
# (name, (B, H, W), offset of the logits in their buffer, all labels ignored):
# the checks beside the main shape, in f32 and bf16. (3, 18, 22) leaves NHWC a
# 4-pixel tail and sends PHASE (W/2 odd) to the scalar unit; the offset view
# sits off the 16-byte grid (the scalar unit)
CE_CM_EXTRA = [("ragged", (3, 18, 22), 0, False), ("all-ignore", (4, IMAGE, IMAGE), 0, True),
               ("misaligned view", (4, IMAGE, IMAGE), 1, False)]


def ce_cm_inputs(torch, dev, g, layout, dtype, b, h, w, offset=0, ignore_all=False):
    shape = (b, h, w, 3) if layout == "nhwc" else (b, h // 2, w // 2, 12)
    buf = torch.randn(b * h * w * 3 + offset, device=dev, generator=g).to(dtype)
    labels = torch.randint(0, 4, (b, h, w), device=dev, generator=g, dtype=torch.int32)
    if ignore_all:
        labels.fill_(3)
    return buf[offset:].view(shape), labels


def ce_cm_check(torch, fused_tail, layout, logits, labels, cw, tag) -> tuple[float, float, str]:
    """One forward and one backward against the plain versions, twice each
    (bitwise equal), one launch each on the unit the call's plan names.
    Returns (loss error, dlogits error, unit)."""
    nhwc = layout == "nhwc"
    fwd = fused_tail.ce_cm_fwd_nhwc if nhwc else fused_tail.ce_cm_fwd_phase
    bwd = fused_tail.ce_cm_bwd_nhwc if nhwc else fused_tail.ce_cm_bwd_phase
    plain_f = fused_tail.ce_cm_forward_plain if nhwc else fused_tail.ce_cm_phase_forward_plain
    plain_b = fused_tail.ce_cm_backward_plain if nhwc else fused_tail.ce_cm_phase_backward_plain
    b, h, w = labels.shape
    plan = fused_tail.ce_cm_plan(b * h * w, h, w, fused_tail.NHWC if nhwc else fused_tail.PHASE,
                                 logits.dtype, fused_tail.alignment(logits, labels))
    before = [dict(f.kernel_launches) for f in (fwd, bwd)]
    loss, cm, tw = fwd(logits, labels, cw)
    loss2, cm2, tw2 = fwd(logits, labels, cw)
    rl, rcm, rtw = plain_f(logits, labels, cw)
    lerr = abs(loss.item() - rl.item())
    require(lerr <= 1e-5 * abs(rl.item()), f"ce_cm {tag}: loss error {lerr:.3e}")
    require(abs(tw.item() - rtw.item()) <= 1e-5 * rtw.item(), f"ce_cm {tag}: weight sum")
    require(torch.equal(cm, rcm), f"ce_cm {tag}: cm {cm.tolist()} != {rcm.tolist()}")
    require(torch.equal(loss, loss2) and torch.equal(cm, cm2) and torch.equal(tw, tw2),
            f"ce_cm {tag} forward not deterministic")
    gs = (1.0 / tw).reshape(1)
    d = bwd(logits, labels, cw, gs)
    d2 = bwd(logits, labels, cw, gs)
    rd = plain_b(logits, labels, cw, gs)
    derr = (d.float() - rd.float()).abs().max().item()
    band = (1e-5 if logits.dtype == torch.float32 else 1e-2) * rd.float().abs().max().item()
    require(d.dtype == logits.dtype and d.shape == logits.shape, f"ce_cm {tag}: dlogits layout")
    require(derr <= band, f"ce_cm {tag}: dlogits error {derr:.3e} > {band:.3e}")
    require(torch.equal(d, d2), f"ce_cm {tag} backward not deterministic")
    for f, was in zip((fwd, bwd), before):
        require(f.kernel_launches == dict(was, **{plan.kernel: was[plan.kernel] + 2}),
                f"ce_cm {tag}: launches {f.kernel_launches}, expected 2 more on {plan.kernel}")
    return lerr, derr, plan.kernel


def phase_ce_cm(torch, fused_tail, layout: str) -> dict:
    """CE+cm forward and backward at the main path's logits shape, in f32 and
    bf16 on the vector unit, then CE_CM_EXTRA. Bands: loss and weight sum
    rtol 1e-5 (f32 sums in another order), cm exact, dlogits within 1e-5
    (f32) or 1e-2 (bf16, one rounding) of max |dlogits|."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    nhwc = layout == "nhwc"
    lay = fused_tail.NHWC if nhwc else fused_tail.PHASE
    fwd = fused_tail.ce_cm_fwd_nhwc if nhwc else fused_tail.ce_cm_fwd_phase
    bwd = fused_tail.ce_cm_bwd_nhwc if nhwc else fused_tail.ce_cm_bwd_phase
    plain_f = fused_tail.ce_cm_forward_plain if nhwc else fused_tail.ce_cm_phase_forward_plain
    plain_b = fused_tail.ce_cm_backward_plain if nhwc else fused_tail.ce_cm_phase_backward_plain
    cw = torch.tensor(CW, device=dev)
    out = {"fwd": {"max_abs_err": 0.0}, "bwd": {"max_abs_err": 0.0}}
    n = BATCH * IMAGE * IMAGE
    for dtype in (torch.float32, torch.bfloat16):
        logits, labels = ce_cm_inputs(torch, dev, g, layout, dtype, BATCH, IMAGE, IMAGE)
        shape = tuple(logits.shape)
        lerr, derr, unit = ce_cm_check(torch, fused_tail, layout, logits, labels, cw,
                                       f"{layout} {dtype}")
        require(unit == "vector", f"ce_cm {layout} {dtype}: main shape on the {unit} unit")
        out["fwd"]["max_abs_err"] = max(out["fwd"]["max_abs_err"], lerr)
        out["bwd"]["max_abs_err"] = max(out["bwd"]["max_abs_err"], derr)
        plan = fused_tail.ce_cm_plan(n, IMAGE, IMAGE, lay, dtype, 16)
        grids = [fused_tail.ce_cm_grid(f, lay, dtype, plan, n, IMAGE, IMAGE) for f in (1, 0)]
        print(f"[ce_cm {layout} plan] {shape} {str(dtype)[6:]}: {plan.kernel} unit of "
              f"{plan.unit} px, {plan.units} units + {plan.tail} tail px; "
              + "; ".join(f"{k} grid {gb} ({ps} blocks/SM), {rg} registers/thread"
                          for k, (gb, ps, rg) in zip(("fwd", "bwd"), grids)), flush=True)
        if dtype != torch.bfloat16:
            continue
        # library yardstick: F.cross_entropy(weight, ignore_index=3) + bincount, on the
        # (B*H*W, 3) view of the interleaved logits; timed here only
        full = logits if nhwc else fused_tail.depth_to_space(logits).contiguous()
        lab64 = labels.reshape(-1).long()
        flat = full.reshape(-1, 3).float().requires_grad_(True)

        def lib_fwd():
            lv = F.cross_entropy(flat, lab64, weight=cw, ignore_index=3)
            cmv = torch.bincount(lab64 * 4 + flat.detach().argmax(-1), minlength=16)
            return lv, cmv

        gs = (1.0 / fwd(logits, labels, cw)[2]).reshape(1)
        lib_loss, _ = lib_fwd()
        fwd_ms = event_ms(torch, lambda: fwd(logits, labels, cw))
        bwd_ms = event_ms(torch, lambda: bwd(logits, labels, cw, gs))
        plain_fwd_ms = event_ms(torch, lambda: plain_f(logits, labels, cw))
        plain_bwd_ms = event_ms(torch, lambda: plain_b(logits, labels, cw, gs))
        lib_fwd_ms = event_ms(torch, lib_fwd)
        lib_bwd_ms = event_ms(torch, lambda: torch.autograd.grad(lib_loss, flat, retain_graph=True))
        in_bytes = logits.numel() * logits.element_size() + n * 4
        fb, fby = bound(in_bytes + 18 * 4, 40 * n)
        bb, bby = bound(in_bytes + logits.numel() * logits.element_size(), 30 * n)
        out["fwd"].update(ms=fwd_ms, plain_ms=plain_fwd_ms, library_ms=lib_fwd_ms,
                          bound_ms=fb, bound_by=fby)
        out["bwd"].update(ms=bwd_ms, plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms,
                          bound_ms=bb, bound_by=bby)
        for k in ("fwd", "bwd"):
            o = out[k]
            print(f"[ce_cm {layout} {k}] {shape} bf16: kernel {o['ms']:.4f} ms "
                  f"({o['bound_ms'] / o['ms'] * 100:.1f}% of the bound), plain "
                  f"{o['plain_ms']:.4f} ms, library {o['library_ms']:.4f} ms, bound "
                  f"{o['bound_ms'] * 1e3:.1f} us", flush=True)
        del flat, lib_loss
    for name, (b, h, w), offset, ignore_all in CE_CM_EXTRA:
        for dtype in (torch.float32, torch.bfloat16):
            logits, labels = ce_cm_inputs(torch, dev, g, layout, dtype, b, h, w, offset,
                                          ignore_all)
            tag = f"{layout} {name} {(b, h, w)} {str(dtype)[6:]}"
            lerr, derr, unit = ce_cm_check(torch, fused_tail, layout, logits, labels, cw, tag)
            print(f"[ce_cm {layout}] {name} {(b, h, w)} {str(dtype)[6:]}: {unit} unit, loss "
                  f"error {lerr:.3e}, dlogits error {derr:.3e}", flush=True)
    earlier = EARLIER_CE_CM_MS[layout]
    print(f"[ce_cm {layout}] before the vector units (recorded, not measured here): fwd "
          f"{earlier['fwd']:.4f} ms, bwd {earlier['bwd']:.4f} ms", flush=True)
    print(f"[ce_cm {layout}] max abs error: loss {out['fwd']['max_abs_err']:.3e}, "
          f"dlogits {out['bwd']['max_abs_err']:.3e}; cm exact; deterministic", flush=True)
    return out


# (B, N, H, D) of the short-attention calls: the MAE ViT-L b64 encoder (24
# calls per direction per step) and decoder (8), then a ragged D-32 shape
# and the ChangeFormer-sized N that the router sends to the same module
ATTN_MAIN = {"encoder": ((64, 49, 16, 64), 24), "decoder": ((64, 196, 16, 64), 8)}
ATTN_EXTRA = {"ragged D32": (2, 77, 8, 32), "N 3136": (2, 3136, 2, 64)}


def attention_work(b: int, n: int, h: int, d: int, elem: int) -> dict:
    """Bytes each direction must move (each input read once, each output
    written once) and the operations of its products. Forward: q, k, v in,
    out and lse out (4t + lse, t one operand's bytes); QK^T and PV. Backward
    as the wgmma kernel runs it: q, k, v, do and out in (delta is computed
    from out inside), lse in, dq, dk, dv out (8t + lse; a kernel handed
    delta moves 7t + lse + delta); the recomputed QK^T, dV, dP, dQ,
    dK."""
    t = b * n * h * d * elem
    stats = b * h * n * 4
    prods = 2 * b * h * n * n * d
    return {"fwd": (4 * t + stats, 2 * prods), "bwd": (8 * t + stats, 5 * prods)}


def short_plan_line(sa, torch, plan, b, n, h, d) -> str:
    """The kernel a plan picked and, for the wgmma kernels, shared memory per
    block, blocks an SM (from the built kernels) and items per block of the
    grid (resident blocks walking the items, or, where the forward holds one
    item stage, one block an item)."""
    if plan.kernel != "wgmma":
        return f"kernel {plan.kernel}, {plan.fwd_smem} / {plan.bwd_smem} B smem"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    items = b * h
    parts = []
    for which in ("fwd", "bwd"):
        smem, per_sm = sa.kernel_footprint(which, d, n, n)
        persistent = which == "bwd" or sa.wgmma_fwd_stages(d, n, n) == 2
        grid = min(items, per_sm * sms) if persistent else items
        walk = f"{items / grid:.2f} items a block" if persistent else \
            f"{grid / (per_sm * sms):.2f} waves"
        parts.append(f"{which} {smem} B smem, {per_sm} blocks/SM, grid {grid} ({walk})")
    return "kernel wgmma: " + "; ".join(parts)


def phase_short_attention(torch, sa) -> dict:
    """B4 forward and backward against the plain versions. q, k, v are the
    column-thirds of one (B, N, 3*H*D) qkv tensor, as the model passes them.
    Bands: f32 out and lse within 1e-5 (relative to max |lse|), gradients
    within 1e-4 of each tensor's max |value| (the same f32 products summed
    in another order, the forward by an online softmax); bf16 out within
    1e-2 of max |out| (the wgmma kernel rounds p/l to bf16 as the plain
    version does; the mma.sync kernel keeps p unrounded), lse within 1e-3,
    gradients within 2e-2 (both round p and ds to bf16 once; a different f32
    sum can round the other way). Two runs bitwise equal; every call on the
    kernel its plan names (bf16 main shapes: wgmma). bf16 times at every
    shape but D 32: both kernels, the backward as the MAE step runs it
    (the wrapper writing dq, dk, dv into the thirds of one qkv gradient, with
    delta), the mma.sync kernels on the same inputs (forward, with its
    error against the plain version; backward with attention_delta and
    autograd's concat), SDPA's forward and
    backward (separate leaves, and one qkv leaf through chunked views: that
    one includes the concat)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "flops": 0.0,
               "max_abs_err": 0.0, "mma_sync_ms": 0.0} for k in ("fwd", "bwd")}
    tot["fwd"]["mma_sync_err"] = 0.0
    tot["bwd"].update(step_ms=0.0, library_qkv_ms=0.0)
    shapes = [(name, shape, count) for name, (shape, count) in ATTN_MAIN.items()]
    shapes += [(name, shape, 0) for name, shape in ATTN_EXTRA.items()]
    fns = (sa.short_attention_fwd, sa.short_attention_bwd)
    for name, (b, n, h, d), count in shapes:
        scale = d**-0.5
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            plan = sa.short_plan(dtype, d, n, n)
            qkv = torch.randn((b, n, 3 * h * d), device=dev, generator=g).to(dtype)
            q, k, v = qkv.chunk(3, dim=-1)
            do = torch.randn((b, n, h * d), device=dev, generator=g).to(dtype)
            before = [dict(f.kernel_launches) for f in fns]
            out, lse = sa.short_attention_fwd(q, k, v, h, scale)
            out2, lse2 = sa.short_attention_fwd(q, k, v, h, scale)
            want_out, want_lse = sa.short_attention_fwd_plain(q, k, v, h, scale)
            tag = f"short_attention {name} {(b, n, h * d)} {dtype}"
            oerr = (out.float() - want_out.float()).abs().max().item()
            lerr = (lse - want_lse).abs().max().item()
            oband = (1e-5 if f32 else 1e-2) * want_out.float().abs().max().item()
            lband = 1e-5 * want_lse.abs().max().item() if f32 else 1e-3
            require(out.dtype == dtype and lse.shape == (b, h, n), f"{tag}: output layout")
            require(oerr <= oband and lerr <= lband,
                    f"{tag}: out error {oerr:.3e} (band {oband:.3e}), lse {lerr:.3e} ({lband:.3e})")
            require(torch.equal(out, out2) and torch.equal(lse, lse2),
                    f"{tag}: fwd not deterministic")
            delta = sa.attention_delta(do, want_out, h)
            grads = sa.short_attention_bwd(q, k, v, do, want_lse, want_out, h, scale)
            again = sa.short_attention_bwd(q, k, v, do, want_lse, want_out, h, scale)
            want = sa.short_attention_bwd_plain(q, k, v, do, want_lse, delta, h, scale)
            gerr = 0.0
            for gname, got, ref, rep in zip(("dq", "dk", "dv"), grads, want, again):
                e = (got.float() - ref.float()).abs().max().item()
                band = (1e-4 if f32 else 2e-2) * ref.float().abs().max().item()
                require(e <= band, f"{tag}: {gname} error {e:.3e} > {band:.3e}")
                require(torch.equal(got, rep), f"{tag}: {gname} not deterministic")
                gerr = max(gerr, e)
            for f, was in zip(fns, before):
                require(f.kernel_launches == dict(was, **{plan.kernel: was[plan.kernel] + 2}),
                        f"{tag}: launches {f.kernel_launches}, expected 2 more on {plan.kernel}")
            print(f"[short_attention] {name} {(b, n, h * d)} D{d} {str(dtype)[6:]}: max abs error "
                  f"out {oerr:.3e}, lse {lerr:.3e}, grads {gerr:.3e}; deterministic; "
                  + short_plan_line(sa, torch, plan, b, n, h, d), flush=True)
            if count and not f32:  # the main path's shapes and dtype
                require(plan.kernel == "wgmma", f"{tag}: plan {plan}")
                tot["fwd"]["max_abs_err"] = max(tot["fwd"]["max_abs_err"], oerr)
                tot["bwd"]["max_abs_err"] = max(tot["bwd"]["max_abs_err"], gerr)
            if f32 or name == "ragged D32":
                continue
            # library yardsticks: SDPA on the (B, H, N, D) views, forward and its
            # autograd backward from separate leaves and from one qkv leaf
            view = lambda t: t.reshape(b, n, h, d).transpose(1, 2)
            lq, lk, lv = (view(t).detach().requires_grad_(True) for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(lq, lk, lv, scale=scale)
            lqkv = qkv.detach().requires_grad_(True)
            lib_qkv_out = F.scaled_dot_product_attention(*(view(t) for t in lqkv.chunk(3, dim=-1)),
                                                         scale=scale)
            ldo = view(do)
            dqkv_views = torch.empty_like(qkv).chunk(3, dim=-1)

            def step_bwd():  # as the MAE step runs it: a new qkv gradient, its thirds written
                dqkv = torch.empty_like(qkv)
                return sa.short_attention_bwd(q, k, v, do, lse, out, h, scale,
                                              *dqkv.chunk(3, dim=-1))

            mma = sa.short_plan(dtype, 32, n, n)  # the mma.sync kernels, same inputs
            mma_out, mma_lse = sa.launch_fwd(mma, q, k, v, h, scale)
            mma_err = (mma_out.float() - want_out.float()).abs().max().item()
            mma_lerr = (mma_lse - want_lse).abs().max().item()
            print(f"[short_attention] {name} {(b, n, h * d)} bf16 forward max abs error against "
                  f"the plain version: {plan.kernel} out {oerr:.3e}, lse {lerr:.3e}; mma.sync on "
                  f"the same inputs out {mma_err:.3e}, lse {mma_lerr:.3e}", flush=True)
            if count:
                tot["fwd"]["mma_sync_err"] = max(tot["fwd"]["mma_sync_err"], mma_err)
            del mma_out, mma_lse

            def mma_bwd():  # their backward: attention_delta, two kernels, autograd's concat
                return torch.cat(sa.launch_bwd(mma, q, k, v, do, lse, out, h, scale), -1)

            ms_f = event_ms(torch, lambda: sa.short_attention_fwd(q, k, v, h, scale))
            ms_b = event_ms(torch, lambda: sa.short_attention_bwd(q, k, v, do, lse, out, h, scale,
                                                                  *dqkv_views))
            ms_step = event_ms(torch, step_bwd)
            mma_f = event_ms(torch, lambda: sa.launch_fwd(mma, q, k, v, h, scale))
            mma_b = event_ms(torch, mma_bwd)
            pl_f = event_ms(torch, lambda: sa.short_attention_fwd_plain(q, k, v, h, scale), reps=3)
            pl_b = event_ms(torch, lambda: sa.short_attention_bwd_plain(q, k, v, do, lse, delta, h,
                                                                        scale), reps=3)
            lib_f = event_ms(torch, lambda: F.scaled_dot_product_attention(lq, lk, lv, scale=scale))
            lib_b = event_ms(torch, lambda: torch.autograd.grad(lib_out, (lq, lk, lv), ldo,
                                                                retain_graph=True))
            lib_bq = event_ms(torch, lambda: torch.autograd.grad(lib_qkv_out, lqkv, ldo,
                                                                 retain_graph=True))
            work = attention_work(b, n, h, d, 2)
            for kdir, ms, pl, lib, mms in (("fwd", ms_f, pl_f, lib_f, mma_f),
                                           ("bwd", ms_b, pl_b, lib_b, mma_b)):
                nbytes, flops = work[kdir]
                bms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
                print(f"[short_attention {kdir}] {name} {(b, n, h * d)} bf16 x{count}/step: "
                      f"{plan.kernel} kernel {ms:.4f} ms, mma.sync {mms:.4f} ms, plain "
                      f"{pl:.4f} ms, SDPA {lib:.4f} ms, bound {bms * 1e3:.1f} us ({by}), "
                      f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
                t = tot[kdir]
                t["ms"] += count * ms
                t["plain_ms"] += count * pl
                t["library_ms"] += count * lib
                t["mma_sync_ms"] += count * mms
                t["bytes"] += count * nbytes
                t["flops"] += count * flops
            tot["bwd"]["step_ms"] += count * ms_step
            tot["bwd"]["library_qkv_ms"] += count * lib_bq
            print(f"[short_attention bwd] {name} {(b, n, h * d)} bf16, the backward as the step "
                  f"runs it (new qkv gradient, thirds written, delta inside): {ms_step:.4f} ms; "
                  f"attention_delta + mma.sync + concat {mma_b:.4f} ms; SDPA backward from "
                  f"one qkv leaf (with the concat) {lib_bq:.4f} ms, separate leaves {lib_b:.4f} "
                  f"ms", flush=True)
            del lq, lk, lv, lib_out, lqkv, lib_qkv_out
    for kdir, t in tot.items():
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], BF16_FLOP_PER_S)
        print(f"[short_attention {kdir}] per MAE train step (24 encoder + 8 decoder calls, bf16): "
              f"wgmma kernel {t['ms']:.3f} ms, mma.sync {t['mma_sync_ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms, SDPA {t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} "
              f"ms ({t['bound_by']}, {t['bytes'] / 1e9:.3f} GB, {t['flops'] / 1e9:.1f} GFLOP)",
              flush=True)
    print(f"[short_attention fwd] max abs error of out at the MAE shapes: wgmma "
          f"{tot['fwd']['max_abs_err']:.3e}, mma.sync on the same inputs "
          f"{tot['fwd']['mma_sync_err']:.3e}", flush=True)
    b_ = tot["bwd"]
    print(f"[short_attention bwd] per MAE train step as the step runs it: wgmma "
          f"{b_['step_ms']:.3f} ms (delta + mma.sync + concat {b_['mma_sync_ms']:.3f} ms); SDPA from one qkv leaf "
          f"{b_['library_qkv_ms']:.3f} ms, separate leaves {b_['library_ms']:.3f} ms", flush=True)
    return tot


# (B, H, Nq, Nk, D, packed) of the flash-attention checks: the whole-scene
# ViT-L encode's call (24 per encode), a ragged Nq != Nk D-32 shape, D 128
# and a ragged D-64 shape
FLASH_MAIN = ("scene", (1, 16, 4096, 4096, 64, True), 24)
FLASH_EXTRA = {"ragged D32": (2, 4, 1003, 1090, 32, False), "D128": (1, 4, 1024, 1024, 128, True),
               "ragged D64": (2, 4, 1003, 1090, 64, False)}
# B5's bf16 times at the main shape before the wgmma kernels (mma.sync with a
# cp.async ring), recorded from an earlier run of this script on an NVIDIA
# H100 80GB HBM3 at 700 W; printed for reference, never measured here
EARLIER_FLASH_MS = {"fwd": 0.3021, "dq": 0.6411, "dkv": 0.9435}


def flash_work(b: int, h: int, nq: int, nk: int, d: int, elem: int) -> dict:
    """Bytes (each input read once, each output written once) and product
    operations of each B5 kernel: forward QK^T and PV; dq the recomputed
    QK^T, dP and dS K; dk/dv QK^T, dP, P^T dO and dS^T Q. The backward as a
    whole needs five products."""
    tq, tk, stats = b * h * nq * d * elem, b * h * nk * d * elem, b * h * nq * 4
    prod = 2 * b * h * nq * nk * d
    return {"fwd": (2 * tq + 2 * tk + stats, 2 * prod),
            "dq": (3 * tq + 2 * tk + 2 * stats, 3 * prod),
            "dkv": (2 * tq + 4 * tk + 2 * stats, 4 * prod),
            "bwd": (3 * tq + 4 * tk + 2 * stats, 5 * prod)}


def flash_inputs(torch, dev, g, b, h, nq, nk, d, packed, dtype):
    if packed:
        qkv = torch.randn((b, nq, 3 * h * d), device=dev, generator=g).to(dtype)
        q, k, v = (t.reshape(b, nq, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.randn((b, h, nq, d), device=dev, generator=g).to(dtype)
        k, v = (torch.randn((b, h, nk, d), device=dev, generator=g).to(dtype) for _ in range(2))
    return q, k, v, torch.randn((b, h, nq, d), device=dev, generator=g).to(dtype)


def flash_plan_line(fa, plan, b, h, nq, nk) -> str:
    """The kernel a plan picked, its shared memory per block and, for the
    wgmma kernels (one 384-thread block an SM), the waves of its grids."""
    blocks = {"fwd": -(-nq // plan.q_tile) * b * h, "dq": -(-nq // plan.q_tile) * b * h,
              "dkv": -(-nk // plan.k_tile) * b * h}
    smem = {"fwd": plan.fwd_smem, "dq": plan.dq_smem, "dkv": plan.dkv_smem}
    parts = []
    for kname in ("fwd", "dq", "dkv"):
        waves = f", {blocks[kname] / SMS:.2f} waves" if plan.kernel == "wgmma" else ""
        parts.append(f"{kname} {smem[kname]} B smem, {blocks[kname]} blocks{waves}")
    return f"kernel {plan.kernel} ({plan.q_tile}/{plan.k_tile}-row tiles): " + "; ".join(parts)


def port_backward(fa, q, k, v, do, out, lse, scale):
    """The whole backward of the port's custom VJP: delta, then dq and dk/dv."""
    return fa.flash_attention_bwd(q, k, v, do, lse, fa.flash_delta(do, out), scale)


def phase_flash_attention(torch, fa) -> dict:
    """B5 forward, dq and dk/dv against the plain versions on the same card
    inputs. Bands: f32 out, lse and gradients within 1e-5 of each tensor's
    max |value| (the same f32 products summed in another order, the forward
    by an online softmax); bf16 out and gradients within 2e-2 of each
    tensor's max |value|, lse within 1e-4 (the kernel rounds p and ds to
    bf16 as tensor-core operands, the plain version keeps them in f32 as
    the TPU kernel does). Two runs bitwise equal; every call on the kernel
    its plan names. bf16 times of the three kernels, the whole port backward
    (flash_delta, dq, dk/dv), SDPA's forward and backward and the forward
    wrapper's host time at every shape; plain versions at the main shape."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    stats = {k: {"max_abs_err": 0.0} for k in ("fwd", "dq", "dkv")}
    counts = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    shapes = [FLASH_MAIN] + [(name, shape, 0) for name, shape in FLASH_EXTRA.items()]
    fns = {"fwd": fa.flash_attention_fwd, "dq": fa.flash_attention_dq,
           "dkv": fa.flash_attention_dkv}
    for name, (b, h, nq, nk, d, packed), count in shapes:
        scale = d**-0.5
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            q, k, v, do = flash_inputs(torch, dev, g, b, h, nq, nk, d, packed, dtype)
            tag = f"flash_attention {name} {(b, h, nq, nk, d)} {dtype}"
            plan = fa.flash_plan(dtype, d, nq, nk)
            before = {kname: dict(fn.kernel_launches) for kname, fn in fns.items()}
            out, lse = fa.flash_attention_fwd(q, k, v, scale)
            out2, lse2 = fa.flash_attention_fwd(q, k, v, scale)
            want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, scale)
            oerr = (out.float() - want_out.float()).abs().max().item()
            lerr = (lse - want_lse).abs().max().item()
            oband = (1e-5 if f32 else 2e-2) * want_out.float().abs().max().item()
            lband = 1e-5 * want_lse.abs().max().item() if f32 else 1e-4
            require(out.dtype == dtype and out.shape == q.shape and lse.shape == (b, h, nq),
                    f"{tag}: output layout")
            require(oerr <= oband and lerr <= lband,
                    f"{tag}: out error {oerr:.3e} (band {oband:.3e}), lse {lerr:.3e} ({lband:.3e})")
            require(torch.equal(out, out2) and torch.equal(lse, lse2),
                    f"{tag}: fwd not deterministic")
            delta = fa.flash_delta(do, want_out)
            args = (q, k, v, do, want_lse, delta, scale)
            dq, again_dq = fa.flash_attention_dq(*args), fa.flash_attention_dq(*args)
            dk, dv = fa.flash_attention_dkv(*args)
            again_dk, again_dv = fa.flash_attention_dkv(*args)
            want = fa.flash_attention_bwd_plain(*args)
            gerr = {}
            for gname, got, ref, rep in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                            (again_dq, again_dk, again_dv)):
                e = (got.float() - ref.float()).abs().max().item()
                band = (1e-5 if f32 else 2e-2) * ref.float().abs().max().item()
                require(got.dtype == dtype and got.shape == ref.shape, f"{tag}: {gname} layout")
                require(e <= band, f"{tag}: {gname} error {e:.3e} > {band:.3e}")
                require(torch.equal(got, rep), f"{tag}: {gname} not deterministic")
                gerr[gname] = e
            for kname, fn in fns.items():
                n = 2  # two runs of each, compared bitwise
                want_k = dict(before[kname])
                want_k[plan.kernel] += n
                require(fn.kernel_launches == want_k,
                        f"{tag}: {kname} launches {fn.kernel_launches}, expected {n} more on the "
                        f"{plan.kernel} kernel")
            print(f"[flash_attention] {name} {(b, h, nq, nk, d)} {str(dtype)[6:]}: max abs error "
                  f"out {oerr:.3e} (band {oband:.3e}), lse {lerr:.3e}, dq {gerr['dq']:.3e}, "
                  f"dk {gerr['dk']:.3e}, dv {gerr['dv']:.3e}; deterministic; "
                  + flash_plan_line(fa, plan, b, h, nq, nk), flush=True)
            if count and not f32:
                stats["fwd"]["max_abs_err"] = oerr
                stats["dq"]["max_abs_err"] = gerr["dq"]
                stats["dkv"]["max_abs_err"] = max(gerr["dk"], gerr["dv"])
            if f32:
                continue
            lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(lq, lk, lv, scale=scale)
            ms = {"fwd": event_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale)),
                  "dq": event_ms(torch, lambda: fa.flash_attention_dq(*args)),
                  "dkv": event_ms(torch, lambda: fa.flash_attention_dkv(*args))}
            lib_f = event_ms(torch, lambda: F.scaled_dot_product_attention(lq, lk, lv, scale=scale))
            lib_b = event_ms(torch, lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                                                retain_graph=True))
            bwd_ms = event_ms(torch, lambda: port_backward(fa, q, k, v, do, want_out, want_lse,
                                                           scale))
            wrapper_ms = host_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale))
            work = flash_work(b, h, nq, nk, d, 2)
            plain = {}
            if count:  # the plain versions materialise (N, N) f32 scores: main shape only
                plain = {"fwd": event_ms(torch, lambda: fa.flash_attention_fwd_plain(q, k, v, scale),
                                         reps=3),
                         "dq": event_ms(torch, lambda: fa.flash_attention_dq_plain(*args), reps=3),
                         "dkv": event_ms(torch, lambda: fa.flash_attention_dkv_plain(*args),
                                         reps=3)}
            for kname in ("fwd", "dq", "dkv"):
                nbytes, flops = work[kname]
                bms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
                lib = lib_f if kname == "fwd" else None  # no library call computes dq or dk/dv alone
                extra = (f", plain {plain[kname]:.4f} ms" if count else "") + \
                        (f", library {lib:.4f} ms" if lib is not None else "")
                print(f"[flash_attention {kname}] {name} {(b, h, nq, nk, d)} bf16 x{count}/encode: "
                      f"kernel {ms[kname]:.4f} ms{extra}, bound {bms * 1e3:.1f} us ({by}), "
                      f"{flops / ms[kname] / 1e9:.1f} TFLOP/s", flush=True)
                if count:
                    stats[kname].update(ms=ms[kname], plain_ms=plain[kname], library_ms=lib,
                                        bound_ms=bms, bound_by=by)
            bb, bby = bound(*work["bwd"], BF16_FLOP_PER_S)
            print(f"[flash_attention bwd] {name} {(b, h, nq, nk, d)} bf16: port backward "
                  f"(flash_delta + dq + dk/dv) {bwd_ms:.4f} ms, SDPA backward {lib_b:.4f} ms "
                  f"({bwd_ms / lib_b:.2f}x); dq + dk/dv kernels {ms['dq'] + ms['dkv']:.4f} ms "
                  f"(7 products); bound of the whole backward {bb * 1e3:.1f} us ({bby}, 5 "
                  f"products); forward {ms['fwd']:.4f} ms, SDPA forward {lib_f:.4f} ms "
                  f"({ms['fwd'] / lib_f:.2f}x); forward wrapper's host time "
                  f"{wrapper_ms * 1e3:.1f} us per call", flush=True)
            if count:
                for kname in ("dq", "dkv"):
                    stats[kname].update(whole_backward_ms=bwd_ms, library_backward_ms=lib_b)
                print(f"[flash_attention] {name}: the mma.sync kernels the wgmma ones replaced "
                      f"(recorded, not measured here): fwd {EARLIER_FLASH_MS['fwd']} ms, dq "
                      f"{EARLIER_FLASH_MS['dq']} ms, dk/dv {EARLIER_FLASH_MS['dkv']} ms",
                      flush=True)
            del lq, lk, lv, lib_out
    stats["dq"]["phase_launches"] = fa.flash_attention_dq.launches - counts[0]
    stats["dkv"]["phase_launches"] = fa.flash_attention_dkv.launches - counts[1]
    return stats


SCENE_SMALL = {"image_size": 64, "patch_size": 16, "dim": 64, "depth": 2, "heads": 2,
               "mlp_dim": 128, "channels": 6, "dim_head": 32}
# the same with heads of 64, the ViT-L's head size: bf16 runs the wgmma forward
SCENE_SMALL_D64 = dict(SCENE_SMALL, dim=128, mlp_dim=256, dim_head=64)


# (B, H, W, Cin, Cout) of the UNet-ResNet18 b128 train step's B6 calls (layer3
# and DecoderBlock_0.ConvBNAct_1 at 14^2, layer4 at 7^2, DecoderBlock_0's
# first conv on the 768-channel concat) and B7 calls (layer2 and
# DecoderBlock_1 at 28^2), with their counts per step; B8 at the two
# small-channel decoder levels (launched by no port path)
CONV_BN_SHAPES = [((BATCH, 14, 14, 256, 256), 4), ((BATCH, 7, 7, 512, 512), 3),
                  ((BATCH, 14, 14, 768, 256), 1)]
CONV_DW_SHAPES = [((BATCH, 28, 28, 128, 128), 4), ((BATCH, 28, 28, 384, 128), 1)]
# ragged bf16 cases (pixel counts that fill no tile, a halo on every side):
# count 0, checked and not added to the per-step totals
CONV_BN_RAGGED = ((3, 7, 7, 256, 256), 0)
CONV_DW_RAGGED = ((2, 9, 11, 128, 128), 0)
# per-step times of the kernels the wgmma ones replaced (mma.sync with
# register-staged loads), recorded from an earlier run of this script on an
# NVIDIA H100 80GB HBM3 at 700 W; printed for reference, never measured here
EARLIER_MS = {"conv3x3_bn_stats": 1.907, "conv3x3_dw": 1.585}
CONV_FUSED_SHAPES = [(BATCH, 224, 224, 16, 16), (BATCH, 112, 112, 32, 32)]
# a last band of 5 of the 8 rows, half bands of 4 x 37 pixels (no multiple of 64)
CONV_FUSED_RAGGED = (3, 21, 37, 32, 16)
ROUTES = {"conv_bn_kernel": True, "dw_kernel": True}


def conv_close(torch, got, want, scale, bf16: bool, tag: str) -> float:
    """The kernel and the plain version sum the same f32 products in another
    order: |got - want| <= 1e-5 * sum(|terms|) (``scale``, per element); a
    bf16 output adds one rounding of each side, at most 2^-8 of each value.
    Returns the max abs error."""
    err = (got.float() - want.float()).abs()
    band = 1e-5 * scale + 1e-6
    if bf16:
        band = band + 2.0**-7 * want.float().abs()
    require(bool((err <= band).all().item()),
            f"{tag}: error {err.max().item():.3e}, over the band by "
            f"{(err - band).max().item():.3e}")
    return err.max().item()


def _new_stats() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "flops": 0.0,
            "max_abs_err": 0.0}


def _add_timing(tot: dict, count: int, ms: float, plain: float, lib: float, nbytes: float,
                flops: float) -> None:
    for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bytes", nbytes),
                   ("flops", flops)):
        tot[key] += count * v


def _finish(tot: dict, rate: float) -> dict:
    tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["flops"], rate)
    return tot


def phase_conv_bn(torch, conv_bn) -> dict:
    """B6 at the main path's three shapes, f32 and bf16, with and without the
    prologue, and at a ragged bf16 shape without it, against the plain
    version (bands of conv_close; the statistics: sum y within 1e-5 of
    sum(|terms|), sum y^2 within 1e-5 of 2 |y| sum(|terms|)); two runs
    bitwise equal. bf16 times without the prologue (the route's call), with
    the kernel the plan picked and its grid; the library yardstick is
    F.conv2d on the channels-last view (cuDNN), which computes no
    statistics."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    tot = _new_stats()
    for (b, h, w, cin, cout), count in CONV_BN_SHAPES + [CONV_BN_RAGGED]:
        for dtype in (torch.float32, torch.bfloat16) if count else (torch.bfloat16,):
            bf16 = dtype == torch.bfloat16
            x = torch.randn((b, h, w, cin), device=dev, generator=g).to(dtype)
            wt = torch.randn((3, 3, cin, cout), device=dev, generator=g) / (3 * cin**0.5)
            wt = wt.to(dtype)
            for prologue in (False, True) if count else (False,):
                sb = ()
                if prologue:
                    sb = (torch.rand(cin, device=dev, generator=g) + 0.5,
                          0.1 * torch.randn(cin, device=dev, generator=g))
                tag = f"conv3x3_bn_stats {(b, h, w, cin)}->{cout} {str(dtype)[6:]}" + \
                    (" prologue" if prologue else "")
                y, st = conv_bn.conv3x3_bn_stats(x, wt, *sb)
                y2, st2 = conv_bn.conv3x3_bn_stats(x, wt, *sb)
                want_y, want_st = conv_bn.conv3x3_bn_stats_plain(x, wt, *sb)
                require(y.dtype == dtype and y.shape == (b, h, w, cout), f"{tag}: layout")
                require(torch.equal(y, y2) and torch.equal(st, st2), f"{tag}: not deterministic")
                xa = torch.relu(x.float() * sb[0] + sb[1]).to(dtype) if prologue else x
                scale = conv_bn.conv3x3_plain_f32(xa.abs(), wt.abs())
                yerr = conv_close(torch, y, want_y, scale, bf16, tag + " y")
                s = scale.reshape(-1, cout)
                sscale = torch.stack([s.sum(0), 2 * (want_y.float().abs().reshape(-1, cout)
                                                     * s).sum(0)])
                serr = conv_close(torch, st, want_st, sscale, False, tag + " stats")
                print(f"[conv_bn] {tag}: max abs error y {yerr:.3e}, stats {serr:.3e}; "
                      f"deterministic", flush=True)
                del scale, s, sscale, want_y, xa
                if not bf16 or prologue:
                    continue
                plan = conv_bn.conv3x3_plan(dtype, b * h * w, cin, cout)
                k0 = conv_bn.conv3x3_bn_stats.kernel_launches[plan.kernel]
                conv_bn.conv3x3_bn_stats(x, wt)
                require(conv_bn.conv3x3_bn_stats.kernel_launches[plan.kernel] == k0 + 1,
                        f"{tag}: the {plan.kernel} kernel did not launch")
                desc = (f"kernel {plan.kernel} ({conv_bn.PIXEL_TILE[plan.kernel]}-pixel tiles, "
                        f"grid ({plan.tiles}, {cout // 128}))")
                tot["max_abs_err"] = max(tot["max_abs_err"], yerr)
                if not count:
                    print(f"[conv_bn] {tag}: {desc}", flush=True)
                    continue
                ms = event_ms(torch, lambda: conv_bn.conv3x3_bn_stats(x, wt))
                plain = event_ms(torch, lambda: conv_bn.conv3x3_bn_stats_plain(x, wt), reps=3,
                                 calls=3)
                xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                lib = event_ms(torch, lambda: F.conv2d(xc, wc, padding=1))
                nbytes = (x.numel() + wt.numel() + b * h * w * cout) * 2 + 2 * cout * 4
                flops = 2.0 * b * h * w * 9 * cin * cout
                bms, _ = bound(nbytes, flops, BF16_FLOP_PER_S)
                print(f"[conv_bn] {tag} x{count}/step: {desc} {ms:.4f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, library "
                      f"(F.conv2d, no statistics) {lib:.4f} ms, bound {bms * 1e3:.1f} us",
                      flush=True)
                _add_timing(tot, count, ms, plain, lib, nbytes, flops)
            del x, wt
    _finish(tot, BF16_FLOP_PER_S)
    print(f"[conv_bn] per train step (8 calls, bf16): kernel {tot['ms']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.3f} ms ({tot['flops'] / 1e9:.1f} GFLOP)", flush=True)
    print(f"[conv_bn] the mma.sync kernel it replaced (recorded, not measured here): "
          f"{EARLIER_MS['conv3x3_bn_stats']} ms per train step", flush=True)
    return tot


def split_ab(torch, conv_dw, x, dy, plan, want) -> str:
    """The wgmma B7 kernel's time at half, the plan's and twice the plan's K
    split and at the splits between, timed in turn in this call (each result
    held to ``want`` by conv_close's band): whether the plan's split is the
    fastest one near it."""
    p = x.shape[0] * x.shape[1] * x.shape[2]
    scale = conv_dw.conv3x3_dw_plain(x.abs(), dy.abs())
    out = []
    for splits in sorted({max(1, plan.splits // 2), max(1, 3 * plan.splits // 4), plan.splits,
                          3 * plan.splits // 2, 2 * plan.splits}):
        slice_ = -(-(-(-p // splits)) // plan.step) * plan.step
        forced = plan._replace(splits=-(-p // slice_), slice=slice_)
        conv_close(torch, conv_dw.launch_dw(forced, x, dy), want, scale, False,
                   f"conv3x3_dw split {forced.splits}")
        ms = event_ms(torch, lambda: conv_dw.launch_dw(forced, x, dy))
        out.append(f"{forced.splits}{' (plan)' if forced == plan else ''} {ms:.4f} ms")
    return ", ".join(out)


def phase_conv_dw(torch, conv_dw) -> dict:
    """B7 at the main path's two shapes, f32 and bf16, and at a ragged bf16
    shape, against the plain version (bands of conv_close, f32 output); two
    runs bitwise equal. bf16 times, with the kernel the plan picked and its
    grid; the library yardstick is torch.nn.grad.conv2d_weight (cuDNN's
    backward-filter), which computes the same function."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    tot = _new_stats()
    for (b, h, w, cin, cout), count in CONV_DW_SHAPES + [CONV_DW_RAGGED]:
        for dtype in (torch.float32, torch.bfloat16) if count else (torch.bfloat16,):
            bf16 = dtype == torch.bfloat16
            x = torch.randn((b, h, w, cin), device=dev, generator=g).to(dtype)
            dy = torch.randn((b, h, w, cout), device=dev, generator=g).to(dtype)
            tag = f"conv3x3_dw {(b, h, w, cin)}->{cout} {str(dtype)[6:]}"
            got = conv_dw.conv3x3_dw(x, dy)
            again = conv_dw.conv3x3_dw(x, dy)
            want = conv_dw.conv3x3_dw_plain(x, dy)
            require(got.dtype == torch.float32 and got.shape == (3, 3, cin, cout),
                    f"{tag}: layout")
            require(torch.equal(got, again), f"{tag}: not deterministic")
            err = conv_close(torch, got, want, conv_dw.conv3x3_dw_plain(x.abs(), dy.abs()),
                             False, tag)
            print(f"[conv_dw] {tag}: max abs error {err:.3e} (max |dW| "
                  f"{want.abs().max().item():.1f}); deterministic", flush=True)
            plan = conv_dw.conv3x3_dw_plan(dtype, b * h * w, cin, cout)
            k0 = conv_dw.conv3x3_dw.kernel_launches[plan.kernel]
            conv_dw.conv3x3_dw(x, dy)
            require(conv_dw.conv3x3_dw.kernel_launches[plan.kernel] == k0 + 1,
                    f"{tag}: the {plan.kernel} kernel did not launch")
            desc = (f"kernel {plan.kernel} ({plan.splits} K slices of {plan.slice} pixels, grid "
                    f"({plan.splits}, {plan.tiles}))")
            if bf16 and not count:
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
                print(f"[conv_dw] {tag}: {desc}", flush=True)
            elif bf16:
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
                ms = event_ms(torch, lambda: conv_dw.conv3x3_dw(x, dy))
                plain = event_ms(torch, lambda: conv_dw.conv3x3_dw_plain(x, dy), reps=3, calls=3)
                xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
                lib = event_ms(torch, lambda: torch.nn.grad.conv2d_weight(
                    xc, (cout, cin, 3, 3), dyc, padding=1))
                nbytes = (x.numel() + dy.numel()) * 2 + 9 * cin * cout * 4
                flops = 2.0 * b * h * w * 9 * cin * cout
                bms, _ = bound(nbytes, flops, BF16_FLOP_PER_S)
                print(f"[conv_dw] {tag} x{count}/step: {desc} {ms:.4f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, library "
                      f"(conv2d_weight) {lib:.4f} ms, bound {bms * 1e3:.1f} us", flush=True)
                _add_timing(tot, count, ms, plain, lib, nbytes, flops)
                print(f"[conv_dw] {tag}: K split A/B, "
                      + split_ab(torch, conv_dw, x, dy, plan, want), flush=True)
            del x, dy, got, again, want
    _finish(tot, BF16_FLOP_PER_S)
    print(f"[conv_dw] per train step (5 calls, bf16): kernel {tot['ms']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.3f} ms ({tot['flops'] / 1e9:.1f} GFLOP)", flush=True)
    print(f"[conv_dw] the mma.sync kernel it replaced (recorded, not measured here): "
          f"{EARLIER_MS['conv3x3_dw']} ms per train step", flush=True)
    return tot


def phase_conv_fused(torch, conv_fused) -> dict:
    """B8 at the two small-channel decoder shapes, f32 and bf16, ReLU on and
    off, and at a ragged bf16 shape (a last band shorter than R, half bands
    of 148 pixels: m64 tiles across output rows; edge pixels 64 times
    larger, so a halo read from the wrong place shows), against the plain
    version (bands of conv_close); two runs bitwise equal; bf16 on the slab
    kernel and f32 on the CUDA-core kernel, by their counters. bf16 times
    with ReLU, one call at each shape, in turn in this call: the slab
    kernel, the mma.sync kernel it replaced (same inputs, its error too),
    the library yardstick F.conv2d with bias, then relu, and the plain
    version. The slab plan's grid is held to the kernel's own occupancy
    (the blocks the card holds at once, no second wave). max_abs_err and
    mma_sync_err are the main shapes'; the ragged shape's (64x edge pixels)
    are ragged_max_abs_err and ragged_mma_sync_err."""
    import torch.nn.functional as F

    from kurosiwo_torch.ops.conv_bn import conv3x3_plain_f32

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    tot = dict(_new_stats(), mma_sync_ms=0.0, mma_sync_err=0.0, copy_ms=0.0,
               ragged_max_abs_err=0.0, ragged_mma_sync_err=0.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, h, w, cin, cout in CONV_FUSED_SHAPES + [CONV_FUSED_RAGGED]:
        main = (b, h, w, cin, cout) != CONV_FUSED_RAGGED
        for dtype in (torch.float32, torch.bfloat16) if main else (torch.bfloat16,):
            bf16 = dtype == torch.bfloat16
            x = torch.randn((b, h, w, cin), device=dev, generator=g)
            if not main:
                for edge in (x[:, 0], x[:, -1], x[:, :, 0], x[:, :, -1]):
                    edge *= 64
            x = x.to(dtype)
            wt = torch.randn((3, 3, cin, cout), device=dev, generator=g) / (3 * cin**0.5)
            wt = wt.to(dtype)
            bias = 0.1 * torch.randn(cout, device=dev, generator=g)
            scale = conv3x3_plain_f32(x.abs(), wt.abs()) + bias.abs()
            plan = conv_fused.conv3x3_fused_plan(dtype, b, h, w, cin, cout,
                                                 x.data_ptr() % 16 == 0, sms)
            require(plan.kernel == ("slab" if bf16 else "simt"),
                    f"conv3x3_fused {(b, h, w, cin)}->{cout}: plan {plan}")
            per_sm = conv_fused.slab_blocks_per_sm(w, cin, cout, plan.rows) if bf16 else 0
            require(not bf16 or plan.grid == min(b * -(-h // plan.rows), sms * per_sm),
                    f"conv3x3_fused {(b, h, w, cin)}->{cout}: grid {plan.grid}, not the "
                    f"{sms} x {per_sm} blocks the card holds at once")
            for relu in (True, False):
                tag = f"conv3x3_fused {(b, h, w, cin)}->{cout} {str(dtype)[6:]} relu={relu}"
                k0 = conv_fused.conv3x3_fused.kernel_launches[plan.kernel]
                got = conv_fused.conv3x3_fused(x, wt, bias, relu)
                require(torch.equal(got, conv_fused.conv3x3_fused(x, wt, bias, relu)),
                        f"{tag}: not deterministic")
                require(conv_fused.conv3x3_fused.kernel_launches[plan.kernel] == k0 + 2,
                        f"{tag}: the {plan.kernel} kernel did not launch")
                want = conv_fused.conv3x3_fused_plain(x, wt, bias, relu)
                require(got.dtype == dtype and got.shape == (b, h, w, cout), f"{tag}: layout")
                err = conv_close(torch, got, want, scale, bf16, tag)
                print(f"[conv_fused] {tag}: kernel {plan.kernel}, max abs error {err:.3e}; "
                      f"deterministic", flush=True)
                key = "max_abs_err" if main else "ragged_max_abs_err"
                if bf16:
                    tot[key] = max(tot[key], err)
                if not (bf16 and relu):
                    continue
                mma_plan = plan._replace(kernel="mma_sync")
                mma_err = conv_close(torch, conv_fused.launch_fused(mma_plan, x, wt, bias),
                                     want, scale, True, tag + " mma_sync")
                key = "mma_sync_err" if main else "ragged_mma_sync_err"
                tot[key] = max(tot[key], mma_err)
                desc = (f"slab kernel (bands of {plan.rows} rows, {conv_fused.SLABS} slabs in "
                        f"flight, {plan.smem} shared bytes, grid {plan.grid} for "
                        f"{b * -(-h // plan.rows)} bands, {per_sm} block(s) an SM at once)")
                if not main:
                    print(f"[conv_fused] {tag}: {desc}; mma.sync max abs error {mma_err:.3e}",
                          flush=True)
                    continue
                ms = event_ms(torch, lambda: conv_fused.conv3x3_fused(x, wt, bias, True))
                mma = event_ms(torch, lambda: conv_fused.launch_fused(mma_plan, x, wt, bias))
                xc = x.permute(0, 3, 1, 2)
                wc = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                bc = bias.to(dtype)
                lib = event_ms(torch, lambda: torch.relu(F.conv2d(xc, wc, bc, padding=1)))
                plain = event_ms(torch, lambda: conv_fused.conv3x3_fused_plain(x, wt, bias, True),
                                 reps=3, calls=2)
                # the same bytes moved by a plain device copy (Cin = Cout: x into a y-sized
                # buffer): the rate this card reaches for a stream in and a stream out
                ybuf = torch.empty_like(x)
                copy = event_ms(torch, lambda: ybuf.copy_(x))
                del ybuf
                nbytes = (x.numel() + wt.numel() + b * h * w * cout) * 2 + cout * 4
                flops = 2.0 * b * h * w * 9 * cin * cout
                bms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
                print(f"[conv_fused] {tag}: {desc} {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                      f"{bms / ms:.0%} of the bound), the mma.sync kernel it replaced {mma:.4f} ms "
                      f"(max abs error {mma_err:.3e}), library (F.conv2d + relu) {lib:.4f} ms, "
                      f"plain {plain:.4f} ms, bound {bms * 1e3:.1f} us ({by}); a copy of x into "
                      f"a y-sized buffer {copy:.4f} ms", flush=True)
                _add_timing(tot, 1, ms, plain, lib, nbytes, flops)
                tot["mma_sync_ms"] += mma
                tot["copy_ms"] += copy
            del x, wt, scale
    _finish(tot, BF16_FLOP_PER_S)
    print(f"[conv_fused] both shapes, one call each (bf16, ReLU): slab kernel {tot['ms']:.3f} ms, "
          f"mma.sync {tot['mma_sync_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
          f"({tot['bytes'] / 1e9:.3f} GB), copies of the same bytes {tot['copy_ms']:.3f} ms",
          flush=True)
    return tot


def phase_scene_parity(torch, fa) -> None:
    """vit_whole_scene of a 512x512x6 scene at patch 16 (32x32 = 1,024
    tokens, the flash route; depth 2, 2 heads: dim 64 with heads of 32, and
    dim 128 with heads of 64), card (kernels) against CPU (plain versions),
    same weights; every forward on the kernel its plan names (bf16: mma.sync
    at D 32, wgmma at D 64). Bands: f32 within 1e-4 absolute (f32 products
    and LayerNorms in another order over two layers); bf16 within 5e-2
    absolute at D 32 (a few bf16 ulps of the final LayerNorm's outputs,
    which reach about 4, where one ulp is 1.6e-2 to 3.1e-2), and within two
    bf16 ulps of the largest |output| at D 64 (the wider model's outputs
    differ by 1.5 ulps in [4, 8) on an H100)."""
    import numpy as np

    from kurosiwo_torch.inference import vit_whole_scene
    from kurosiwo_torch.models.vit import ViT

    scene = np.random.RandomState(3).randn(512, 512, 6).astype(np.float32)
    for cfg in (SCENE_SMALL, SCENE_SMALL_D64):
        cpu_vit = ViT(**cfg, pool="cls", generator=torch.Generator().manual_seed(7))
        gpu_vit = copy.deepcopy(cpu_vit).to("cuda")
        for dtype, band in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            kernel = fa.flash_plan(dtype, cfg["dim_head"], 1024, 1024).kernel
            n0 = dict(fa.flash_attention_fwd.kernel_launches)
            got = vit_whole_scene(gpu_vit, scene, dtype=dtype, device="cuda")
            launched = {k: n - n0[k] for k, n in fa.flash_attention_fwd.kernel_launches.items()}
            want = vit_whole_scene(cpu_vit, scene, dtype=dtype, device="cpu")
            err = (got.float().cpu() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            if dtype == torch.bfloat16 and cfg["dim_head"] == 64:
                band = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)  # two bf16 ulps at max |out|
            tag = f"{str(dtype)[6:]} D{cfg['dim_head']}"
            require(got.shape == want.shape == (1, 1024, cfg["dim"]),
                    f"scene parity {tag}: shape {got.shape}")
            want_k = dict.fromkeys(launched, 0)
            want_k[kernel] = cfg["depth"]
            require(launched == want_k, f"scene parity {tag}: flash launches {launched}")
            require(err <= band, f"scene parity {tag}: error {err:.3e} > {band:.1e}")
            print(f"[parity] scene ViT 512x512 (1,024 tokens) {tag} card vs CPU: max abs error "
                  f"{err:.3e} (band {band:.3e}, max |out| {top:.3f}), {cfg['depth']} "
                  f"flash_attention_fwd launches on the {kernel} kernel", flush=True)


def phase_scene_main(torch, counters, smi: str) -> dict:
    """Serving at full width: the ViT-L 1024x1024 encode (bench.py's scene
    leg), a 1000x1000 encode (63x63 grid, off the flash route) and the
    UNet-ResNet18 sliding-window map of a 2048x2048x6 scene."""
    import numpy as np

    from kurosiwo_torch import bench
    from kurosiwo_torch.inference import TilePredictor, predict_scene, vit_whole_scene
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.ops import short_attention as sa

    warmup, encodes = 3, 10
    sb = bench.setup_scene(1024)
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    rates, out = bench.run_scene(sb, encodes, 1, warmup=warmup)
    launches = read_counters(counters)
    seconds = sum(1 / r for r in rates)
    n = warmup + encodes
    require(out.shape == (1, 4096, 1024) and bool(torch.isfinite(out).all().item()),
            f"scene encode output {tuple(out.shape)} not finite or misshapen")
    by_kernel = read_kernel_counters(counters)
    want = {name: 0 for name in counters}
    want.update(flash_attention_fwd=24 * n)
    require(launches == want, f"scene launches {launches}, expected 24 flash fwd per encode "
                              f"over {n} encodes")
    want_k = dict.fromkeys(by_kernel, 0)
    want_k["flash_attention_fwd.wgmma"] = 24 * n
    require(by_kernel == want_k, f"scene kernel launches {by_kernel}, expected 24 wgmma B5 "
                                 f"forwards per encode and no other bf16 B5 forward")
    print(f"[main] scene ViT-L 1024x1024 (4,096 tokens) bf16: {encodes / seconds:.3f} scenes/s "
          f"({seconds / encodes * 1e3:.2f} ms/encode), launches {launches} over {n} encodes "
          f"(flash_attention_fwd.wgmma {by_kernel['flash_attention_fwd.wgmma']}), "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)

    scene = np.random.RandomState(1).randn(1000, 1000, 6).astype(np.float32)
    zero_counters(counters)
    t0 = time.perf_counter()
    out = vit_whole_scene(sb.vit, scene)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    off = read_counters(counters)
    want = {name: 0 for name in counters}
    want.update(short_attention_fwd=24)
    require(out.shape == (1, 63 * 63, 1024) and bool(torch.isfinite(out).all().item()),
            f"1000x1000 encode output {tuple(out.shape)}")
    require(off == want, f"1000x1000 launches {off}, expected 24 short fwd and no flash")
    require(sa.short_attention_fwd.kernel_launches["mma_sync"] == 24,
            f"1000x1000 B4 kernels {sa.short_attention_fwd.kernel_launches}, expected the 24 "
            f"forwards of 3,969 tokens on mma.sync")
    print(f"[main] scene ViT-L 1000x1000 (63x63 = 3,969 tokens, no 128-multiple block: off the "
          f"flash route): one encode with upload {ms:.2f} ms, launches {off}", flush=True)
    del sb, out
    torch.cuda.empty_cache()

    cfg = bench.build_config("unet", 32)
    model = initialize_segmentation_model(cfg, bench.MODEL_CONFIG, seed=0)
    pred = TilePredictor(model, tile=224, batch_size=32)
    scene = np.random.RandomState(2).randn(2048, 2048, 6).astype(np.float32)
    predict_scene(pred, scene, overlap=32)  # warm-up (cuDNN autotuning)
    zero_counters(counters)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        mask = predict_scene(pred, scene, overlap=32)
    seconds = time.perf_counter() - t0
    unet = read_counters(counters)
    tiles = 11 * 11
    require(mask.shape == (2048, 2048) and set(np.unique(mask).tolist()) <= {0, 1, 2},
            f"predict_scene mask {mask.shape}")
    require(unet == {name: 0 for name in counters}, f"predict_scene launches {unet}")
    print(f"[main] UNet-ResNet18 predict_scene 2048x2048x6 (tile 224, overlap 32, {tiles} tiles, "
          f"batch 32, bf16): {reps * tiles / seconds:.1f} tiles/s, {reps / seconds:.3f} scenes/s "
          f"({seconds / reps * 1e3:.1f} ms/scene, host blending included), launches {unet} "
          f"(its eval forward runs no port kernel) [{smi}]", flush=True)
    return launches


def adam_step_close(got: dict, want: dict, lr: float) -> tuple[float, float]:
    """(max |diff|, share within 3e-4) over all parameters: Adam's first step
    is lr*g/(|g|+eps), so a gradient whose sign differs moves by up to 2*lr."""
    import torch

    d = torch.cat([(got[k].cpu() - want[k].cpu()).abs().reshape(-1) for k in want])
    return d.max().item(), (d <= 3e-4).float().mean().item()


def phase_parity(torch, counters, routes: bool = False) -> None:
    """f32 train + eval step, card (kernels) against CPU (plain versions);
    with ``routes`` the conv kernel routes are on (B6 and B7 in f32, TF32
    off), and the card's train step must launch B6 8 times and B7 5 times.
    Bands as tests/test_torch_steps.py: loss rtol 1e-4; cm row sums equal,
    cells within 0.1% of the valid pixels; parameters all within 2*lr and 99%
    within 3e-4; batch statistics atol 1e-4."""
    from kurosiwo_torch import bench
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.state import create_train_state
    from kurosiwo_torch.training.steps import make_eval_step, make_train_step

    cfg = dict(bench.build_config("unet", 4), mixed_precision=False, fused_tail=True)
    if routes:
        cfg.update(ROUTES)
    mc = bench.MODEL_CONFIG
    batch = bench.host_batch(4, 64, seed=1)
    valid = int((batch["mask"] != 3).sum())
    cpu_model = initialize_segmentation_model(cfg, mc, device="cpu", seed=3)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    res = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        state = create_train_state(model, cfg, mc)
        step = make_train_step(model, create_loss(cfg, "train"), cfg, mc, device=name)
        zero_counters(counters)
        state, ms, loss = step(state, batch, MetricState.create(name), 1e-3)
        launched = read_counters(counters)
        by_kernel = read_kernel_counters(counters)
        ev = make_eval_step(model, create_loss(cfg, "val"), cfg, mc, device=name)
        ems, eloss, _ = ev(state, batch, MetricState.create(name))
        res[name] = dict(loss=loss.item(), cm=ms.cm.cpu(), eloss=eloss.item(), ecm=ems.cm.cpu(),
                         state={k: v.detach().cpu() for k, v in model.state_dict().items()})
    c, g = res["cpu"], res["cuda"]
    routed = (launched["conv3x3_bn_stats"], launched["conv3x3_dw"])
    require(routed == ((8, 5) if routes else (0, 0)),
            f"parity train step launched B6 {routed[0]}, B7 {routed[1]} times")
    simt = (by_kernel["conv3x3_bn_stats.simt"], by_kernel["conv3x3_dw.simt"])
    conv_k = {k: v for k, v in by_kernel.items() if k.startswith("conv3x3")}
    require(simt == routed and sum(conv_k.values()) == sum(routed),
            f"parity train step (f32) launched B6/B7 kernels {conv_k}")
    ce_k = {k: v for k, v in by_kernel.items() if k.startswith("ce_cm")}
    require(ce_k == dict.fromkeys(ce_k, 0) | {"ce_cm_fwd_nhwc.vector": 1,
                                              "ce_cm_bwd_nhwc.vector": 1},
            f"parity train step launched CE+cm units {ce_k}, expected one vector each way")
    params = {k for k, _ in cpu_model.named_parameters()}
    for key in ("loss", "eloss"):
        require(abs(g[key] - c[key]) <= 1e-4 * abs(c[key]), f"parity {key}: {g[key]} vs {c[key]}")
    for key in ("cm", "ecm"):
        require(torch.equal(g[key].sum(1), c[key].sum(1)), f"parity {key} row sums")
        require((g[key] - c[key]).abs().max().item() <= 1e-3 * valid, f"parity {key} cells")
    pmax, pshare = adam_step_close({k: g["state"][k] for k in params},
                                   {k: c["state"][k] for k in params}, 1e-3)
    require(pmax <= 2e-3 + 1e-6 and pshare >= 0.99, f"parity params: max {pmax}, share {pshare}")
    smax = max((g["state"][k] - c["state"][k]).abs().max().item()
               for k in c["state"] if k not in params)
    require(smax <= 1e-4, f"parity batch stats: {smax}")
    print(f"[parity] f32 (4,64,64,6){' conv routes on' if routes else ''} card vs CPU: "
          f"loss {g['loss']:.6f} vs {c['loss']:.6f}, "
          f"eval loss {g['eloss']:.6f} vs {c['eloss']:.6f}, cm max diff "
          f"{(g['cm'] - c['cm']).abs().max().item():.0f} of {valid} px, params max "
          f"{pmax:.2e} ({pshare * 100:.2f}% within 3e-4), batch stats max {smax:.2e}", flush=True)


MAE_SMALL = {"image_size": 112, "patch_size": 16, "dim": 128, "depth": 2, "heads": 2,
             "mlp_dim": 256, "decoder_dim": 64, "decoder_depth": 1, "decoder_heads": 2,
             "masked_ratio": 0.75}
MAE_LR = 1e-4


def phase_mae_parity(torch, counters) -> None:
    """One MAE train step at (4, 112, 112, 6) (49 patches, 13 kept, the
    ragged tiles of the main path's encoder), card (kernels) against CPU
    (plain versions), same weights, images and noise; in f32 (the SIMT
    kernels) and in bf16 (the wgmma kernels the main path runs: 3 B4 calls
    each way, the encoder's 2 and the decoder's 1). f32
    bands as tests/test_torch_mae.py: loss rtol 1e-4; parameters all within
    2*lr and 99% within 0.3*lr (Adam's first update is about lr*sign(g)).
    bf16: loss rtol 2e-2 as test_bf16_mae_keeps_f32_masters_and_close_loss;
    every gradient within 5e-2 of its tensor's max |grad| (the kernel's own
    2e-2 band, compounded by bf16 roundings of 2^-8 at every product of
    three layers); parameters all within 2*lr, as Adam bounds any step."""
    import numpy as np

    from kurosiwo_torch.models.factory import build_mae
    from kurosiwo_torch.training.mae import make_mae_train_step
    from kurosiwo_torch.training.state import create_train_state

    rs = np.random.RandomState(2)
    images = rs.randn(4, 112, 112, 6).astype(np.float32)
    noise = rs.rand(1, 4, 49).astype(np.float32)
    for bf16 in (False, True):
        cfg = {"num_channels": 6, "mixed_precision": bf16}
        cpu_model = build_mae(cfg, MAE_SMALL, device="cpu", seed=5)
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        res = {}
        for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            state = create_train_state(model, cfg, {"learning_rate": MAE_LR}, task="mae")
            step = make_mae_train_step(model, accum=1, device=name)
            zero_counters(counters)
            state, loss = step(state, {"image": images}, MAE_LR, noise=torch.from_numpy(noise))
            by_kernel = read_kernel_counters(counters)
            res[name] = dict(loss=loss.item(),
                             params={k: v.detach().cpu() for k, v in model.named_parameters()},
                             grads={k: (torch.zeros_like(v) if v.grad is None else v.grad)
                                    .detach().float().cpu()
                                    for k, v in model.named_parameters()})
        c, g = res["cpu"], res["cuda"]
        tag = "bf16" if bf16 else "f32"
        kernel = "wgmma" if bf16 else "simt"
        want_k = dict.fromkeys(by_kernel, 0)
        want_k.update({f"short_attention_fwd.{kernel}": 3, f"short_attention_bwd.{kernel}": 3})
        require(by_kernel == want_k, f"MAE {tag} parity kernel launches {by_kernel}, expected 3 "
                                     f"B4 calls each way on the {kernel} kernels")
        rtol = 2e-2 if bf16 else 1e-4
        require(abs(g["loss"] - c["loss"]) <= rtol * abs(c["loss"]),
                f"MAE {tag} parity loss: {g['loss']} vs {c['loss']}")
        d = torch.cat([(g["params"][k] - c["params"][k]).abs().reshape(-1) for k in c["params"]])
        pmax, share = d.max().item(), (d <= 0.3 * MAE_LR).float().mean().item()
        require(pmax <= 2 * MAE_LR + 1e-7 and (bf16 or share >= 0.99),
                f"MAE {tag} parity params: max {pmax}, share within 0.3*lr {share}")
        gerr = max(((g["grads"][k] - c["grads"][k]).abs().max()
                    / c["grads"][k].abs().max().clamp_min(1e-30)).item() for k in c["grads"])
        if bf16:
            require(gerr <= 5e-2, f"MAE bf16 parity grads: max relative error {gerr}")
        print(f"[parity] MAE {tag} (4,112,112,6) card vs CPU: loss {g['loss']:.6f} vs "
              f"{c['loss']:.6f}, grads max err {gerr:.2e} of each tensor's max, params max "
              f"{pmax:.2e} ({share * 100:.2f}% within 0.3*lr)", flush=True)


def phase_mae_main(torch, counters, smi: str) -> dict:
    """The MAE ViT-L batch-64 bf16 train step through bench.py's code."""
    from kurosiwo_torch import bench

    warmup, steps = 3, 10
    b = bench.setup_mae()
    batch = b.batch["image"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    seconds, loss = bench.run_mae_train(b, steps, warmup)
    launches = read_counters(counters)
    n = warmup + steps
    require(bool(torch.isfinite(loss).item()), f"MAE loss not finite: {loss.item()}")
    by_kernel = read_kernel_counters(counters)
    want = {name: 0 for name in counters}
    want.update(short_attention_fwd=32 * n, short_attention_bwd=32 * n)
    require(launches == want, f"MAE launches {launches}, expected 32 fwd / 32 bwd per step "
                              f"over {n} steps")
    want_k = dict.fromkeys(by_kernel, 0)
    want_k.update({"short_attention_fwd.wgmma": 32 * n, "short_attention_bwd.wgmma": 32 * n})
    require(by_kernel == want_k, f"MAE kernel launches {by_kernel}, expected every B4 call on "
                                 f"the wgmma kernels")
    print(f"[main] MAE ViT-L b{batch} bf16: {steps * batch / seconds:.2f} patches/s "
          f"({seconds / steps * 1e3:.2f} ms/step), loss {loss.item():.5f}, launches {launches} "
          f"over {n} steps (short_attention_fwd.wgmma {by_kernel['short_attention_fwd.wgmma']}, "
          f"short_attention_bwd.wgmma {by_kernel['short_attention_bwd.wgmma']}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)
    return {name: by_kernel[f"{name}.wgmma"]
            for name in ("short_attention_fwd", "short_attention_bwd")}


def bank_counts_all(metric, pixels: int) -> bool:
    """The f32 cm bank holds every valid pixel once. Its cells pass 2^24
    over several b128 steps, where f32 stops counting exactly, hence the
    relative band of 1e-6."""
    return abs(metric.cm.sum().item() - pixels) <= 1e-6 * pixels


def zero_counters(counters) -> None:
    for fn in counters.values():
        fn.launches = 0
        for kernel in getattr(fn, "kernel_launches", {}):
            fn.kernel_launches[kernel] = 0


def read_counters(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def read_kernel_counters(counters) -> dict:
    """{"<wrapper>.<kernel>": launches} of the wrappers that count by kernel
    (B4, B5, B6 and B7)."""
    return {f"{name}.{k}": n for name, fn in counters.items()
            for k, n in getattr(fn, "kernel_launches", {}).items()}


def require_ce_units(counters, want: dict, tag: str) -> None:
    """Every CE+cm launch of a main-path run on the vector unit: ``want``
    {wrapper: launches}, every other CE+cm wrapper and unit 0."""
    got = {k: v for k, v in read_kernel_counters(counters).items() if k.startswith("ce_cm")}
    expect = dict.fromkeys(got, 0) | {f"{name}.vector": n for name, n in want.items()}
    require(got == expect, f"{tag}: CE+cm launches by unit {got}, expected {expect}")


def phase_main_path(torch, counters, smi: str) -> dict:
    from kurosiwo_torch import bench

    warmup, steps = 3, 10
    b = bench.setup(BATCH)
    valid = int((b.batch["mask"] != 3).sum().item())
    out = {}
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    seconds, loss, metric = bench.run_train(b, steps, warmup)
    launches = read_counters(counters)
    n = warmup + steps
    require(bool(torch.isfinite(loss).item()), f"train loss not finite: {loss.item()}")
    want = {name: 0 for name in counters}
    want.update(pair_sums=60 * n, ce_cm_fwd_nhwc=n, ce_cm_bwd_nhwc=n)
    require(launches == want, f"train launches {launches}, expected 60/1/1 per step over {n} steps")
    require_ce_units(counters, {"ce_cm_fwd_nhwc": n, "ce_cm_bwd_nhwc": n}, "train")
    require(bank_counts_all(metric, n * valid), "train cm bank does not count every valid pixel")
    out["train"] = launches
    print(f"[main] train b{BATCH} bf16: {steps * BATCH / seconds:.2f} patches/s "
          f"({seconds / steps * 1e3:.2f} ms/step), loss {loss.item():.5f}, launches {launches} "
          f"over {n} steps, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]",
          flush=True)
    default_rate = steps * BATCH / seconds
    for f32 in (False, True):
        torch.cuda.reset_peak_memory_stats()
        zero_counters(counters)
        seconds, loss, metric = bench.run_eval(b, steps, warmup, f32=f32)
        launches = read_counters(counters)
        tag = "f32-twin" if f32 else "bf16"
        require(bool(torch.isfinite(loss).item()), f"eval {tag} loss not finite")
        # two forward launches per eval step: loss on every pixel, and the cm
        # bank with sample_weight-0 samples dropped
        want = {name: 0 for name in counters}
        want.update(ce_cm_fwd_nhwc=2 * n)
        require(launches == want, f"eval {tag} launches {launches}")
        require_ce_units(counters, {"ce_cm_fwd_nhwc": 2 * n}, f"eval {tag}")
        require(bank_counts_all(metric, n * valid), f"eval {tag} cm bank count")
        out[f"eval_{tag}"] = launches
        print(f"[main] eval b{BATCH} {tag}: {steps * BATCH / seconds:.2f} patches/s "
              f"({seconds / steps * 1e3:.2f} ms/step), loss {loss.item():.5f}, launches "
              f"{launches} over {n} steps, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB [{smi}]", flush=True)
    del b
    torch.cuda.empty_cache()
    # the same step with both conv kernel routes on: B6 takes 8 convs' forward
    # and BN statistics (their forward pair sums go), B7 5 convs' dW
    b = bench.setup(BATCH, overrides=ROUTES)
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    seconds, loss, metric = bench.run_train(b, steps, warmup)
    launches = read_counters(counters)
    require(bool(torch.isfinite(loss).item()), f"routed train loss not finite: {loss.item()}")
    want = {name: 0 for name in counters}
    want.update(pair_sums=52 * n, conv3x3_bn_stats=8 * n, conv3x3_dw=5 * n, ce_cm_fwd_nhwc=n,
                ce_cm_bwd_nhwc=n)
    require(launches == want, f"routed train launches {launches}, expected 52 pair_sums, 8 B6, "
                              f"5 B7 and 1/1 CE+cm per step over {n} steps")
    by_kernel = read_kernel_counters(counters)
    want_k = dict.fromkeys(by_kernel, 0)
    want_k.update({"conv3x3_bn_stats.wgmma": 8 * n, "conv3x3_dw.wgmma": 5 * n,
                   "ce_cm_fwd_nhwc.vector": n, "ce_cm_bwd_nhwc.vector": n})
    require(by_kernel == want_k, f"routed train kernel launches {by_kernel}, expected the "
                                 f"wgmma B6 8 and the wgmma B7 5 times and the CE+cm vector "
                                 f"unit once each way per step over {n} steps")
    out["train_routes_kernels"] = by_kernel
    require(bank_counts_all(metric, n * valid), "routed train cm bank count")
    out["train_routes"] = launches
    print(f"[main] train b{BATCH} bf16, conv routes on (B6, B7): {steps * BATCH / seconds:.2f} "
          f"patches/s ({seconds / steps * 1e3:.2f} ms/step; default route {default_rate:.2f} "
          f"patches/s in this run), loss {loss.item():.5f}, launches {launches} over {n} steps "
          f"(by kernel {by_kernel}), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{smi}]", flush=True)
    return out


def main() -> int:
    try:
        import torch

        from kurosiwo_torch import kernels
        from kurosiwo_torch.ops import batchnorm, conv_bn, conv_dw, conv_fused, fused_tail
        from kurosiwo_torch.ops import flash_attention as fa
        from kurosiwo_torch.ops import short_attention as sa
    except ImportError as e:
        print(f"FAIL: cannot import the port ({e}); run from the repository root", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script needs an NVIDIA GPU",
              flush=True)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"pair_sums": batchnorm.pair_sums,
                "ce_cm_fwd_nhwc": fused_tail.ce_cm_fwd_nhwc,
                "ce_cm_bwd_nhwc": fused_tail.ce_cm_bwd_nhwc,
                "ce_cm_fwd_phase": fused_tail.ce_cm_fwd_phase,
                "ce_cm_bwd_phase": fused_tail.ce_cm_bwd_phase,
                "short_attention_fwd": sa.short_attention_fwd,
                "short_attention_bwd": sa.short_attention_bwd,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_dq": fa.flash_attention_dq,
                "flash_attention_dkv": fa.flash_attention_dkv,
                "conv3x3_bn_stats": conv_bn.conv3x3_bn_stats,
                "conv3x3_dw": conv_dw.conv3x3_dw,
                "conv3x3_fused": conv_fused.conv3x3_fused}
    t0 = time.perf_counter()
    try:
        smi = phase_device(torch)
        phase_build(kernels)
        pair = phase_pair_sums(torch, batchnorm)
        ce = phase_ce_cm(torch, fused_tail, "nhwc")
        phase = phase_ce_cm(torch, fused_tail, "phase")
        print(f"[ce_cm phase] PHASE instantiation (no port path launches it yet): fwd "
              f"{phase['fwd']['ms']:.4f} ms, bwd {phase['bwd']['ms']:.4f} ms", flush=True)
        torch.cuda.empty_cache()
        attn = phase_short_attention(torch, sa)
        flash = phase_flash_attention(torch, fa)
        torch.cuda.empty_cache()
        cbn = phase_conv_bn(torch, conv_bn)
        cdw = phase_conv_dw(torch, conv_dw)
        cfu = phase_conv_fused(torch, conv_fused)
        torch.cuda.empty_cache()
        phase_parity(torch, counters)
        phase_parity(torch, counters, routes=True)
        phase_mae_parity(torch, counters)
        phase_scene_parity(torch, fa)
        unet = phase_main_path(torch, counters, smi)
        launches, routed = unet["train"], unet["train_routes"]
        torch.cuda.empty_cache()
        mae_launches = phase_mae_main(torch, counters, smi)
        torch.cuda.empty_cache()
        scene_launches = phase_scene_main(torch, counters, smi)
    except (PhaseFailed, RuntimeError, ValueError, TypeError, subprocess.SubprocessError,
            OSError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", flush=True)
        return 1

    def row(name, source, replaces, stats, n):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
                "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
                "bound_by": stats["bound_by"], "library_ms": stats["library_ms"]}

    table = {"kernels": [
        row("ce_cm_fwd_phase (no port path launches it)", "kurosiwo_torch/csrc/ce_cm.cu",
            "kurosiwo_tpu/ops/pallas_tail.py:305", phase["fwd"], launches["ce_cm_fwd_phase"]),
        row("ce_cm_bwd_phase (no port path launches it)", "kurosiwo_torch/csrc/ce_cm.cu",
            "kurosiwo_tpu/ops/pallas_tail.py:345", phase["bwd"], launches["ce_cm_bwd_phase"]),
        row("pair_sums (per train step: 30 fwd + 30 bwd calls)",
            "kurosiwo_torch/csrc/pair_sums.cu", "kurosiwo_tpu/ops/pallas_bn.py:48", pair,
            launches["pair_sums"]),
        row("ce_cm_fwd_nhwc", "kurosiwo_torch/csrc/ce_cm.cu", "kurosiwo_tpu/ops/pallas_tail.py:128",
            ce["fwd"], launches["ce_cm_fwd_nhwc"]),
        row("ce_cm_bwd_nhwc", "kurosiwo_torch/csrc/ce_cm.cu", "kurosiwo_tpu/ops/pallas_tail.py:167",
            ce["bwd"], launches["ce_cm_bwd_nhwc"]),
        dict(row("short_attention_fwd (the wgmma kernel; per MAE train step: 24 encoder + 8 "
                 "decoder calls)", "kurosiwo_torch/csrc/short_attention.cu",
                 "kurosiwo_tpu/ops/pallas_attention.py:259", attn["fwd"],
                 mae_launches["short_attention_fwd"]),
             mma_sync_ms=attn["fwd"]["mma_sync_ms"],
             mma_sync_max_abs_err=attn["fwd"]["mma_sync_err"]),
        dict(row("short_attention_bwd (the wgmma kernel; per MAE train step: 24 encoder + 8 "
                 "decoder calls; step_backward_ms: as the step runs it, into the qkv gradient's "
                 "thirds; library_qkv_backward_ms: SDPA's from one qkv leaf, with the concat)",
                 "kurosiwo_torch/csrc/short_attention.cu",
                 "kurosiwo_tpu/ops/pallas_attention.py:283", attn["bwd"],
                 mae_launches["short_attention_bwd"]),
             step_backward_ms=attn["bwd"]["step_ms"],
             library_qkv_backward_ms=attn["bwd"]["library_qkv_ms"],
             mma_sync_backward_ms=attn["bwd"]["mma_sync_ms"]),
        row("flash_attention_fwd (the wgmma kernel; per call at (1, 16, 4096, 64); 24 per "
            "scene encode)",
            "kurosiwo_torch/csrc/flash_attention.cu", "kurosiwo_tpu/ops/pallas_attention.py:33",
            flash["fwd"], scene_launches["flash_attention_fwd"]),
        # the backward runs on no serving path: launches is the scene main path's
        # count (0), phase_launches the kernel-vs-plain phase's
        dict(row("flash_attention_dq (the wgmma kernel; backward, no serving path runs it; "
                 "whole_backward_ms: flash_delta + dq + dk/dv)",
                 "kurosiwo_torch/csrc/flash_attention.cu",
                 "kurosiwo_tpu/ops/pallas_attention.py:63", flash["dq"],
                 scene_launches["flash_attention_dq"]),
             phase_launches=flash["dq"]["phase_launches"],
             whole_backward_ms=flash["dq"]["whole_backward_ms"],
             library_backward_ms=flash["dq"]["library_backward_ms"]),
        dict(row("flash_attention_dkv (the wgmma kernel; backward, no serving path runs it)",
                 "kurosiwo_torch/csrc/flash_attention.cu",
                 "kurosiwo_tpu/ops/pallas_attention.py:86", flash["dkv"],
                 scene_launches["flash_attention_dkv"]),
             phase_launches=flash["dkv"]["phase_launches"],
             whole_backward_ms=flash["dkv"]["whole_backward_ms"],
             library_backward_ms=flash["dkv"]["library_backward_ms"]),
        row("conv3x3_bn_stats (B6, the wgmma kernel; per train step with the conv routes on: "
            "8 calls; library: F.conv2d, no statistics)", "kurosiwo_torch/csrc/conv3x3.cu",
            "kurosiwo_tpu/ops/pallas_conv_bn.py:79", cbn,
            unet["train_routes_kernels"]["conv3x3_bn_stats.wgmma"]),
        row("conv3x3_dw (B7, the wgmma kernel; per train step with the conv routes on: 5 calls)",
            "kurosiwo_torch/csrc/conv_dw.cu", "kurosiwo_tpu/ops/pallas_dw.py:48", cdw,
            unet["train_routes_kernels"]["conv3x3_dw.wgmma"]),
        dict(row("conv3x3_fused (B8, the slab kernel: TMA halo slabs, resident weights, wgmma, "
                 "TMA stores; no port path launches it; one call at each of (128,224,224,16)->16 "
                 "and (128,112,112,32)->32; mma_sync_ms: the mma.sync kernel it replaced, same "
                 "inputs)", "kurosiwo_torch/csrc/conv_fused.cu",
                 "kurosiwo_tpu/ops/pallas_conv.py:40", cfu, routed["conv3x3_fused"]),
             mma_sync_ms=cfu["mma_sync_ms"], mma_sync_max_abs_err=cfu["mma_sync_err"],
             ragged_max_abs_err=cfu["ragged_max_abs_err"],
             ragged_mma_sync_max_abs_err=cfu["ragged_mma_sync_err"]),
    ]}
    print(f"[done] {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
