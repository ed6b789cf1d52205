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
6. The segmentation engine (run right after the UNet main path), in a
   temporary directory: the port's load_config(method="unet",
   backbone="resnet18") on configs/ (b128, 224x224, bf16 on f32
   parameters, Adam, cosine lr, the f32 eval twin, AOI banks on) over
   synthetic splits of 320 samples; 2 epochs (2 train steps and 3 val
   batches each), a resume to 3 epochs from ``latest``, and an eval-only
   engine on the saved best. Required: finite losses; 60 pair_sums and one
   CE+cm launch each way per train step, two CE+cm forwards per eval batch,
   all on the vector unit; the train and val banks (and the AOI banks)
   count every valid pixel, padding left out; the checkpoint pointers name
   written slots; the resume starts at epoch 2 and ``latest`` holds 3
   epochs of steps; the final state is best_segmentation's; the eval-only
   test banks have the trained engine's totals and mIoU (within 0.01);
   ``latest`` restored on the card equals the file mapped to the CPU. These
   short epochs' times include the loader's start-up. Then the timed
   epoch: 12 steps (1,536 synthetic samples) of the trained engine, with
   the loader alone on the same split (both after the loader's start-up),
   and the same 12 steps from 4
   decoded batches held in memory (no loader running). It prints each epoch's seconds,
   patches/s and the share of host time spent waiting on the loader
   (without the smoke's own pixel counting), the loader alone, the train
   step's rate from phase 5, the card's busy time a step (torch.profiler)
   and so its idle share of the timed epoch, and the peak memory.
   The packed feed: a synthetic split of 512 samples at 224^2 packed in
   float16 (0.36 GB) into a temporary directory and read from the warm
   page cache; the 4-step b128 epoch of one engine, the loader alone and
   the step's host time outside the wait, from the decoded source and from
   the pack, by the Loader's decode processes and by decode threads (the
   A/B's other arm, ``ThreadRows`` here); batch 0 bitwise equal across the
   arms and to the plain decode stacked; the same steps with no loader
   running; the card's busy time a step, its idle share and peak memory.
   The augmentations: augment_batch's applies on the card against the
   CPU's with the card's draws at b8 224^2 (the shipped config, and every
   operation at p = 1), then the b128 augmented train step beside the plain
   one. The other losses (iou, dice, focal, ce+dice) and the zone banks: a
   small f32 train and eval step, card against CPU, then the b128 train
   step and the f32-twin eval step with their launches and rates.
7. The CLI: ``python -m kurosiwo_torch --method unet --backbone resnet18
   --seed 7`` in a subprocess and a temporary directory, on the shipped
   configs (b128, one epoch, the default synthetic splits, AOI banks on):
   exit 0 and a ``Test Mean IOU:`` line. Beside it ROADMAP C14: the same
   run twice with ``deterministic: false`` (cuDNN's autotuner) and twice
   with ``deterministic: true``, printing the first-step loss, the train
   and val metrics and the test mIoU; the deterministic pair must agree.
   These runs and every later phase's CLI runs go to one pool, run after
   the last phase (9.), beside no timed step.
   Then change detection: each of the five convolutional methods
   (SNUNet-ECAM at base_channel 8, Siam-diff, Siam-conc, ADHR-CDNet,
   HFA-Net at 224^2) in one f32 train and eval step, card against CPU, the
   card's Dropout2d masks replayed on the CPU, the pair-sum kernel launched
   once for each plain call of the CPU step; remat on against off on the
   card (SNUNet's column plan, Siam-diff's whole-forward region with
   dropout): equal running statistics, gradients in the f32 band, equal
   pair-sum launches; the SNUNet b128 bf16 train step with remat on (the
   default) and off (2 warm-up, 5 timed, as every change-detection leg;
   its peak memory must be lower with remat) and its f32-twin eval, the
   Siam-diff b128 train step, HFA-Net and ADHR-CDNet at the larger of b64,
   b32 that fits, each with
   patches/s, peak memory, pair-sum launches a step and the card's busy
   time a step (torch.profiler); one SNUNet b128 step with ``fused_tail:
   true`` (B2) against the plain tail; and ``python -m kurosiwo_torch
   --method snunet --seed 7`` twice on the shipped configs (the cd task on
   pre_event_1 and post_event, deterministic by default): exit 0, a
   ``Test Mean IOU:`` line, ``checkpoint_epoch=0`` written, the same
   printed numbers. The phase prints its wall time.
   Then the rest of the segmentation zoo (the seg-zoo phase): UNet++ and
   DeepLabV3+ (resnet18, resnet50), UperNet (ConvNeXt, Swin) and the
   FloodViT finetuner (mlp, decoder, linear heads) each in one f32 train and
   eval step at a small size, card against CPU, B3 and B4 launched once for
   each plain call of the CPU step; Swin's relative-position gradients
   bitwise equal over two deterministic backwards; the b128 bf16 train step
   (2 warm-up, 3 timed; 3 and 10 before the MAE-loop and recurrent phases
   joined the script, 2 and 5 before the diffusion phase) and f32-twin eval
   (2 warm-up, 3 timed) of unet++
   resnet18, deeplabv3 resnet18, upernet convnext_tiny, finetune (ViT-L
   1024 x 24, 16 heads, mlp 2048, mlp head; at the larger of b64, b32 that
   fits, b128 does not), upernet swin_tiny and deeplabv3 resnet50, with
   patches/s, peak memory, B3 and
   B4 launches a step (B3 twice a BatchNorm; B4 24 each way on the wgmma
   kernels for the finetuner) and the card's busy time a step; B3 against
   its plain version at every BatchNorm input shape of those steps, B4 at
   the finetuner's (B, 197, 16 x 64), its time beside SDPA's and its bound;
   the CLI twice at one seed for unet++, deeplabv3, upernet and finetune
   (at the batch its leg fit) on the shipped configs, every printed number
   equal.
   Then MAE pretraining end to end (the mae-train phase): the loop
   (``training/mae.train``: the SSL loader, the schedule, bf16-moment Adam
   with ``lr_scales``, mae_{e}/vit_{e}) at a small size, f32, card against
   CPU with the card's masking noise replayed, B4 launched once for each
   plain call; the loop at full width (the shipped mae.json: ViT-L, accum
   4, b128, synthetic SSL source, 2 epochs of 4 steps, the second timed;
   8 before the diffusion phase):
   patches/s, the host time a step outside the loader wait, the SSL loader
   alone, the card's idle share (torch.profiler), the peak memory, B4
   launches a step (128 each way, all wgmma) and the seconds and bytes of
   each save; B4 against its plain version at the loop's microbatch shapes
   beside SDPA and its bound; ``python -m kurosiwo_torch --method mae`` with
   ``"task": "mae"`` (exit 0, finite losses, mae_0 and vit_0 written). And
   the recurrent task (the recurrent phase): the ConvLSTM's f32 train and
   eval step card against CPU at (2, 3, 64, 64, 2); its b128 bf16 train
   step (b64 or b32 where b128 does not fit) and f32-twin eval with
   patches/s, peak memory and the card's busy time a step; one step with
   ``fused_tail: true`` (B2 once each way) against the plain tail; B2
   against its plain version at the step's f32 probabilities; ``python -m
   kurosiwo_torch --method convlstm --seed 7`` twice (``checkpoint_epoch=0``
   written, every printed number equal). And diffusion pretraining with the
   raster CLI (the diffusion phase): the DDPM (dim 16, dim_mults (1, 2),
   32^2, f32) in a 10-step ``sample`` chain and one train step (the loss,
   every gradient, Adam's update), card against CPU from the same weights,
   timesteps and noise; the shipped diffusion.json (dim 64, dim_mults (1,
   2, 4, 8), 1000 timesteps, 224^2 x 2, bf16 on f32 parameters) in its
   train step at the first of b128, b64, b32 that fits (2 warm-up, 5 timed,
   2 profiled: patches/s, peak memory, the card's busy time a step and its
   cuDNN, elementwise and reduction shares) and one whole 1000-step chain
   at (1, 224, 224, 2) (its seconds, a finite output of the right shape),
   every kernel counter 0 across both; the raster CLI's inputs, a 2048^2
   VV/VH pair as float32 TIFFs (cv2) and the best_segmentation of the
   CLI's model (the UNet on post_event's 2 channels; the engine phase's
   takes 6) after 4 engine steps, and its in-process predict_scene under
   deterministic algorithms (no kernel launched); ``python -m kurosiwo_torch
   --method diffusion --seed 7`` at the leg's batch (exit 0, finite losses,
   diffusion_0 written) and ``python -m kurosiwo_torch.inference --vv ...
   --vh ... --checkpoint <dir>/best_segmentation`` (exit 0, the mask PNG
   bitwise the in-process map, the overlay written), both in the pool.
   And weights from the reference's files (the weights phase): a seeded
   3-channel torchvision-layout ResNet-18 .pth and a seeded full-width
   6-channel smp-layout UNet-ResNet18 .pt, each read back through the
   port's converters bit for bit; ``load_config(unet, resnet18)`` on a
   config root whose unet.json names the .pth as ``pretrained_encoder``
   (b128, 224², bf16): the engine's encoder bitwise the file's before step
   1 (the 6-channel stem at its init), 2 train steps and one f32 eval
   batch with their B2 and B3 launches counted, the train step on those
   batches resident on the card in turns with a twin engine of the same
   config from its random init (20 steps a turn), beside the main path's
   step rate, and the load's seconds; ``kurosiwo_torch.parity`` on the .pt over 64 synthetic test
   samples in-process on the card (B2's forward counted) and on the CPU
   (plain versions), their confusion counts within 0.1% of the pixels and
   their scores within 0.1 points; ``python -m kurosiwo_torch --method
   unet --backbone resnet18`` on that config root (exit 0, the load
   printed, a test mIoU) and ``python -m kurosiwo_torch.parity --model
   unet`` on the .pt (its report held to the CPU's in the same band), both
   in the pool. Their numbers close the output in a ``[slice summary]``
   line.
8. Phase 5's MAE ViT-L train step and serving paths, run after the other
   phases (their launch counts fill the kernel table).
9. The CLI pool: every CLI run of the phases above (26), at most 6 at once
   while their estimated peaks (each model's leg peak plus its context) sum
   to at most 62 GiB, the runs of 31 GiB and more first (the largest first,
   the others beside them at nice 10, in phase order); then each phase's
   checks of its runs, in phase order. It prints its wall time and the card's memory in
   use at most (nvidia-smi).
10. The kernel table as one JSON line (B3's row with the change-detection
   and zoo steps' pair-sum launches, B4's with the finetuner's and the MAE
   loop's, B2's with the recurrent step's, B2's and B3's with the weights
   leg's), then the result line
   ``{"ok": true, "device": {...}}``.

``--only engine,feed,augment,losses,c14,cd,cd-attn,seg-zoo,mae-train,recurrent,diffusion,weights``
runs the device and build phases and then only those phases: a partial
run, which prints no kernel table and no result line.
"""

from __future__ import annotations

import contextlib
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


def pair_sums_check(torch, batchnorm, a, b, label: str) -> tuple[float, float]:
    """pair_sums(a, b) against its plain version on the same inputs, and
    twice (deterministic). Band: |kernel - plain| <= 1e-5 * sum of |terms|
    per channel (both sum the same f32 values in another order). Returns the
    largest error, absolute and as a share of the sum of |terms|."""
    c = a.shape[-1]
    got = batchnorm.pair_sums(a, b)
    again = batchnorm.pair_sums(a, b)
    want = batchnorm.pair_sums_plain(a, b)
    af, bf = a.float().reshape(-1, c), b.float().reshape(-1, c)
    scale = torch.stack([af.abs().sum(0), (af * bf).abs().sum(0)])
    err = (got - want).abs()
    require(bool((err <= 1e-5 * scale + 1e-6).all()),
            f"pair_sums {label}: error {err.max().item():.3e}")
    require(torch.equal(got, again), f"pair_sums {label} not deterministic")
    return err.max().item(), (err / scale.clamp_min(1e-30)).max().item()


def phase_pair_sums(torch, batchnorm) -> dict:
    """pair_sums at every BN shape of the step, f32 and bf16, (x, x) and
    (dy, x), held to ``pair_sums_check``'s band."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "flops": 0.0,
           "bytes": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0}
    for (h, w, c), count in BN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((BATCH, h, w, c), device=dev, generator=g).to(dtype)
            dy = torch.randn((BATCH, h, w, c), device=dev, generator=g).to(dtype)
            for a, b in ((x, x), (dy, x)):
                err, rel = pair_sums_check(torch, batchnorm, a, b, f"{(BATCH, h, w, c)} {dtype}")
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
                tot["max_rel_err"] = max(tot["max_rel_err"], rel)
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


def ce_cm_times(torch, fused_tail, layout: str, logits, labels, cw) -> dict:
    """{"fwd", "bwd"}: the kernels' device times at ``logits`` beside the
    plain versions', the library yardstick's (F.cross_entropy with the
    class weights and ignore_index 3, plus a bincount for the cm, on the
    (B*H*W, 3) view of the interleaved logits; its autograd backward) and
    the bound."""
    import torch.nn.functional as F

    nhwc = layout == "nhwc"
    fwd = fused_tail.ce_cm_fwd_nhwc if nhwc else fused_tail.ce_cm_fwd_phase
    bwd = fused_tail.ce_cm_bwd_nhwc if nhwc else fused_tail.ce_cm_bwd_phase
    plain_f = fused_tail.ce_cm_forward_plain if nhwc else fused_tail.ce_cm_phase_forward_plain
    plain_b = fused_tail.ce_cm_backward_plain if nhwc else fused_tail.ce_cm_phase_backward_plain
    n = labels.numel()
    full = logits if nhwc else fused_tail.depth_to_space(logits).contiguous()
    lab64 = labels.reshape(-1).long()
    flat = full.reshape(-1, 3).float().requires_grad_(True)

    def lib_fwd():
        lv = F.cross_entropy(flat, lab64, weight=cw, ignore_index=3)
        cmv = torch.bincount(lab64 * 4 + flat.detach().argmax(-1), minlength=16)
        return lv, cmv

    gs = (1.0 / fwd(logits, labels, cw)[2]).reshape(1)
    lib_loss, _ = lib_fwd()
    times = {"fwd": dict(ms=event_ms(torch, lambda: fwd(logits, labels, cw)),
                         plain_ms=event_ms(torch, lambda: plain_f(logits, labels, cw)),
                         library_ms=event_ms(torch, lib_fwd)),
             "bwd": dict(ms=event_ms(torch, lambda: bwd(logits, labels, cw, gs)),
                         plain_ms=event_ms(torch, lambda: plain_b(logits, labels, cw, gs)),
                         library_ms=event_ms(torch, lambda: torch.autograd.grad(
                             lib_loss, flat, retain_graph=True)))}
    in_bytes = logits.numel() * logits.element_size() + n * 4
    for k, (nbytes, ops) in (("fwd", (in_bytes + 18 * 4, 40 * n)),
                             ("bwd", (in_bytes + logits.numel() * logits.element_size(),
                                      30 * n))):
        times[k]["bound_ms"], times[k]["bound_by"] = bound(nbytes, ops)
    return times


def phase_ce_cm(torch, fused_tail, layout: str) -> dict:
    """CE+cm forward and backward at the main path's logits shape, in f32 and
    bf16 on the vector unit, then CE_CM_EXTRA. Bands: loss and weight sum
    rtol 1e-5 (f32 sums in another order), cm exact, dlogits within 1e-5
    (f32) or 1e-2 (bf16, one rounding) of max |dlogits|."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    lay = fused_tail.NHWC if layout == "nhwc" else fused_tail.PHASE
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
        for k, times in ce_cm_times(torch, fused_tail, layout, logits, labels, cw).items():
            out[k].update(times)
        for k in ("fwd", "bwd"):
            o = out[k]
            print(f"[ce_cm {layout} {k}] {shape} bf16: kernel {o['ms']:.4f} ms "
                  f"({o['bound_ms'] / o['ms'] * 100:.1f}% of the bound), plain "
                  f"{o['plain_ms']:.4f} ms, library {o['library_ms']:.4f} ms, bound "
                  f"{o['bound_ms'] * 1e3:.1f} us", flush=True)
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


def card_and_cpu_steps(torch, counters, cfg: dict) -> dict:
    """One f32 train step and one eval step of the UNet at (4, 64, 64, 6) on
    the CPU and on the card from the same weights and batch: their losses,
    banks and states, the card train step's launches, the valid pixels and
    the parameter names."""
    from kurosiwo_torch import bench
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.state import create_train_state
    from kurosiwo_torch.training.steps import make_eval_step, make_train_step

    mc = bench.MODEL_CONFIG
    batch = bench.host_batch(4, 64, seed=1)
    cpu_model = initialize_segmentation_model(cfg, mc, device="cpu", seed=3)
    out = {"valid": int((batch["mask"] != 3).sum()),
           "params": {k for k, _ in cpu_model.named_parameters()}}
    for name, model in (("cpu", cpu_model), ("cuda", copy.deepcopy(cpu_model).to("cuda"))):
        state = create_train_state(model, cfg, mc)
        step = make_train_step(model, create_loss(cfg, "train"), cfg, mc, device=name)
        zero_counters(counters)
        state, ms, loss = step(state, batch, MetricState.create(name), 1e-3)
        out["launched"], out["by_kernel"] = read_counters(counters), read_kernel_counters(counters)
        ev = make_eval_step(model, create_loss(cfg, "val"), cfg, mc, device=name)
        ems, eloss, _ = ev(state, batch, MetricState.create(name))
        out[name] = dict(loss=loss.item(), cm=ms.cm.cpu(), eloss=eloss.item(), ecm=ems.cm.cpu(),
                         zones=ms.zones.cpu(), ezones=ems.zones.cpu(),
                         state={k: v.detach().cpu() for k, v in model.state_dict().items()})
    return out


def phase_parity(torch, counters, routes: bool = False) -> None:
    """f32 train + eval step, card (kernels) against CPU (plain versions);
    with ``routes`` the conv kernel routes are on (B6 and B7 in f32, TF32
    off), and the card's train step must launch B6 8 times and B7 5 times.
    Bands as tests/test_torch_steps.py: loss rtol 1e-4; cm row sums equal,
    cells within 0.1% of the valid pixels; parameters all within 2*lr and 99%
    within 3e-4; batch statistics atol 1e-4."""
    from kurosiwo_torch import bench

    cfg = dict(bench.build_config("unet", 4), mixed_precision=False, fused_tail=True)
    if routes:
        cfg.update(ROUTES)
    res = card_and_cpu_steps(torch, counters, cfg)
    c, g, valid, params = res["cpu"], res["cuda"], res["valid"], res["params"]
    launched, by_kernel = res["launched"], res["by_kernel"]
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
    default_rate = out["train_rate"] = steps * BATCH / seconds
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

# the engine phase's synthetic splits: 320 samples each, so an epoch is 2
# train steps of b128 (64 samples dropped) and 3 val or test batches, the
# last padded with 64 zero-weight samples; these short epochs check the
# engine, and their times include the loader's start-up (the first batch is
# decoded before any step). The timed epoch has ENGINE_LONG_SAMPLES: 12
# steps, where the start-up is one batch in 12 (20 before the zoo phase
# joined the script, within its time limit).
ENGINE_SAMPLES = 320
ENGINE_LONG_SAMPLES = 1536
ENGINE_SEED = 11


class CountingLoader:
    """A Loader that also counts the valid pixels of the samples it yields
    (labels other than 3, padding samples left out), one total an epoch, and
    the host seconds that counting took (``count_s``), so the epoch's times
    can leave it out."""

    def __init__(self, loader):
        self.loader = loader
        self.valid, self.count_s = [], []

    def __len__(self):
        return len(self.loader)

    def num_samples(self):
        return self.loader.num_samples()

    def __iter__(self):
        return self._counted(iter(self.loader))

    def ring_batches(self, pin: bool = False):
        """The Loader's ring batches (the engine's upload path), counted."""
        return self._counted(self.loader.ring_batches(pin))

    def _counted(self, batches):
        n, seconds = 0, 0.0
        for batch in batches:
            t0 = time.perf_counter()
            n += int(((batch["mask"] != 3) & (batch["sample_weight"][:, None, None] > 0)).sum())
            seconds += time.perf_counter() - t0
            yield batch
        self.valid.append(n)
        self.count_s.append(seconds)


class Tee:
    """A stdout that keeps what is written and passes it on."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_engine(torch, counters, smi: str, step_rate: float) -> dict:
    """The segmentation engine at full width, in a temporary directory: the
    port's load_config(method="unet", backbone="resnet18") on the
    repository's configs (b128, 224x224, bf16 on f32 parameters, Adam,
    cosine lr, the f32 eval twin, AOI banks on) over synthetic splits of
    ENGINE_SAMPLES; 2 epochs, then a resume to 3, then an eval-only engine
    on the saved best. ``step_rate`` is the main path's train step rate in
    this run (bench.run_train), printed beside the epoch rates."""
    import contextlib
    import os
    import tempfile
    from pathlib import Path

    import numpy as np

    from kurosiwo_torch import bench
    from kurosiwo_torch.config import create_checkpoint_directory, load_config
    from kurosiwo_torch.data.pipeline import Loader, prepare_loaders
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.training import engine as eng
    from kurosiwo_torch.training.checkpoint import CheckpointManager

    root = Path(__file__).resolve().parent
    train_summaries, eval_summaries = [], []
    run_train_epoch, run_eval = eng.TaskEngine.run_train_epoch, eng.TaskEngine.run_eval

    def recording_train(self, loader, epoch):
        train_summaries.append(run_train_epoch(self, loader, epoch))
        return train_summaries[-1]

    def recording_eval(self, loader, settype="Val"):
        t0 = time.perf_counter()
        out = run_eval(self, loader, settype)
        eval_summaries.append((settype, out[3], time.perf_counter() - t0))
        return out

    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            eng.TaskEngine.run_train_epoch = recording_train
            eng.TaskEngine.run_eval = recording_eval
            cfg = load_config(method="unet", backbone="resnet18", config_root=root / "configs",
                              overrides={"synthetic_size": ENGINE_SAMPLES, "epochs": 2})
            mcfg = cfg["model_config"]
            require(cfg["batch_size"] == BATCH and cfg["mixed_precision"]
                    and cfg["log_AOI_metrics"],
                    f"engine config: batch {cfg['batch_size']}, mixed_precision "
                    f"{cfg['mixed_precision']}, log_AOI_metrics {cfg['log_AOI_metrics']}")
            cfg["checkpoint_path"] = create_checkpoint_directory(cfg, mcfg)
            ckpt_dir = Path(cfg["checkpoint_path"])

            # the loader alone: one train epoch, no step
            t0 = time.perf_counter()
            n = 0
            for b in Loader("train", cfg, ENGINE_SEED).ring_batches():
                n += len(b["mask"])
                b.release()
            loader_rate = n / (time.perf_counter() - t0)

            train, val, test = (CountingLoader(x) for x in prepare_loaders(cfg, ENGINE_SEED))
            steps = len(train)
            zero_counters(counters)
            engine = eng.train_task(initialize_segmentation_model(cfg, mcfg, seed=ENGINE_SEED),
                                    train, val, test, cfg, mcfg, "segmentation")
            launches = read_counters(counters)
            want = {name: 0 for name in counters}
            n_train, n_eval = 2 * steps, 2 * len(val)
            want.update(pair_sums=60 * n_train, ce_cm_fwd_nhwc=n_train + 2 * n_eval,
                        ce_cm_bwd_nhwc=n_train)
            require(launches == want, f"engine launches {launches}, expected 60 pair_sums and "
                                      f"1/1 CE+cm per train step ({n_train}) and 2 CE+cm "
                                      f"forwards per eval batch ({n_eval})")
            require_ce_units(counters, {"ce_cm_fwd_nhwc": n_train + 2 * n_eval,
                                        "ce_cm_bwd_nhwc": n_train}, "engine")
            for e, s in enumerate(train_summaries):
                require(math.isfinite(s["mean_loss"]), f"engine epoch {e} loss {s['mean_loss']}")
                require(s["batches"] == steps, f"engine epoch {e} ran {s['batches']} steps")
                require(s["cm"].sum() == train.valid[e],
                        f"engine epoch {e} train bank {s['cm'].sum()} of {train.valid[e]} pixels")
            for e, (settype, s, _) in enumerate(eval_summaries):
                require(settype == "Val" and s["cm"].sum() == val.valid[e],
                        f"engine epoch {e} {settype} bank {s['cm'].sum()} of {val.valid[e]}")
                require(sum(b.sum() for b in s["aoi_banks"].values()) == val.valid[e],
                        f"engine epoch {e} AOI banks")
            ptrs = {}
            for name in ("best_segmentation", "latest"):
                ptr = json.loads((ckpt_dir / f"{name}.ptr.json").read_text())
                slot = ckpt_dir / ptr["slot"]
                require(slot.is_file() and slot.stat().st_size > 0, f"{name} points at {slot}")
                ptrs[name] = ptr
            require((ckpt_dir / "best_segmentation.txt").is_file(), "no best_segmentation.txt")
            # the epochs' times without the smoke's own pixel counting
            epochs = [(s["epoch_time_s"] - train.count_s[e], s["data_wait_s"] - train.count_s[e],
                       v[2] - val.count_s[e])
                      for e, (s, v) in enumerate(zip(train_summaries, eval_summaries))]

            # resume to 3 epochs from latest
            cfg3 = dict(cfg, epochs=3, resume_checkpoint=True)
            train_summaries.clear()
            eval_summaries.clear()
            tee = Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                engine = eng.train_task(initialize_segmentation_model(cfg3, mcfg, seed=1),
                                        train, val, test, cfg3, mcfg, "segmentation")
            require("Resumed from latest checkpoint at epoch 2" in "".join(tee.text),
                    "the resume did not start from latest at epoch 2")
            require(len(train_summaries) == 1, f"the resume ran {len(train_summaries)} epochs")
            epochs.append((train_summaries[0]["epoch_time_s"] - train.count_s[2],
                           train_summaries[0]["data_wait_s"] - train.count_s[2],
                           eval_summaries[0][2] - val.count_s[2]))
            ckpt = CheckpointManager(ckpt_dir, engine.device)
            latest_cpu, extra = ckpt.load("latest", map_location="cpu")
            require(latest_cpu["step"] == 3 * steps and extra["epoch"] == 2,
                    f"latest holds step {latest_cpu['step']}, epoch {extra['epoch']}")
            best_cpu, best = ckpt.load("best_segmentation", map_location="cpu")
            final = engine.model.state_dict()
            require(all(torch.equal(final[k].cpu(), v) for k, v in best_cpu["model"].items()),
                    "the final engine's state is not best_segmentation's")
            _, _, miou, test_summary = eng.TaskEngine.run_eval(engine, test, "Test")

            # eval-only on the saved best, from another initial model
            zero_counters(counters)
            evaluated = eng.evaluate_task(initialize_segmentation_model(cfg, mcfg, seed=2), cfg,
                                          mcfg, "segmentation")
            _, _, eval_miou, eval_summary = eng.TaskEngine.run_eval(evaluated, test, "Test")
            launches = read_counters(counters)
            require(launches == {name: 0 for name in counters} | {"ce_cm_fwd_nhwc": 2 * len(test)},
                    f"eval-only launches {launches}")
            require(eval_summary["cm"].sum() == test_summary["cm"].sum() == test.valid[-1],
                    "eval-only test bank totals")
            require(abs(eval_miou - miou) <= 0.01, f"eval-only mIoU {eval_miou} vs {miou}")

            # latest on the card, against the same file mapped to the CPU
            ckpt.restore("latest", engine.state)
            card = {"model": engine.model.state_dict(),
                    "optimizer": engine.state.optimizer.state_dict()["state"]}
            for k, v in latest_cpu["model"].items():
                require(torch.equal(card["model"][k].cpu(), v), f"latest {k} card vs CPU map")
            for i, st in latest_cpu["optimizer"]["state"].items():
                for k, v in st.items():
                    got = card["optimizer"][i][k]
                    require(torch.equal(got.cpu(), v), f"latest optimizer {i}.{k} card vs CPU")
                    require((k == "step") == (got.device.type == "cpu"),
                            f"restored optimizer {k} on {got.device}")

            # the timed epoch: ENGINE_LONG_SAMPLES, the loader alone (its
            # start-up, the decode processes and the page-locked ring, done
            # before the clock starts), then one train epoch of the trained
            # engine from the same loader, no counting
            long_cfg = dict(cfg, synthetic_size=ENGINE_LONG_SAMPLES)
            long_loader = Loader("train", long_cfg, ENGINE_SEED)
            long_loader._start()
            long_loader._ring.pin()
            held, n = [], 0
            t0 = time.perf_counter()
            for b in long_loader.ring_batches(pin=True):
                n += len(b["mask"])
                if len(held) < 4:
                    held.append({k: v.copy() for k, v in b.items()})
                b.release()
            long_loader_rate = n / (time.perf_counter() - t0)
            long = run_train_epoch(engine, long_loader, 3)
            long_loader.close()
            long_steps = ENGINE_LONG_SAMPLES // BATCH
            require(long["batches"] == long_steps and math.isfinite(long["mean_loss"]),
                    f"the timed epoch ran {long['batches']} steps, loss {long['mean_loss']}")
            # the same number of steps with no loader running: 4 decoded
            # batches held in memory, each taken 5 times
            unloaded = run_train_epoch(engine, held * (long_steps // len(held)), 3)
            require(unloaded["batches"] == long_steps and math.isfinite(unloaded["mean_loss"]),
                    f"the unloaded epoch ran {unloaded['batches']} steps")

            # the card's busy time a train step (torch.profiler over two more
            # short epochs; a step's kernels do not depend on the epoch's length)
            prof = bench.profile(lambda: run_train_epoch(engine, train, 3), 2, engine.device,
                                 1e3 * epochs[-1][0])
        finally:
            eng.TaskEngine.run_train_epoch, eng.TaskEngine.run_eval = run_train_epoch, run_eval
            os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for e, (seconds, wait, val_s) in enumerate(epochs):
        print(f"[engine] check epoch {e} ({steps} steps of b{BATCH}, the loader's start-up "
              f"included): train {seconds:.3f} s, {steps * BATCH / seconds:.2f} patches/s, waiting "
              f"on the loader {wait:.3f} s ({100 * wait / seconds:.1f}% of the epoch's host "
              f"time); val eval {val_s:.3f} s ({val.num_samples() / val_s:.2f} patches/s, "
              f"{len(val)} batches) [{smi}]", flush=True)
    print(f"[engine] loader alone, {steps}-step epoch: {loader_rate:.2f} patches/s; val mIoU best "
          f"{best['metric']:.3f} (epoch {best['epoch']}), test mIoU {miou:.3f}, eval-only "
          f"{eval_miou:.3f}; peak {peak:.2f} GiB [{smi}]", flush=True)
    long_s, long_wait = long["epoch_time_s"], long["data_wait_s"]
    busy = prof["kernel_ms"] / steps * long_steps
    print(f"[engine] timed epoch ({long_steps} steps of b{BATCH}, {ENGINE_LONG_SAMPLES} synthetic "
          f"samples): train {long_s:.3f} s, {long_steps * BATCH / long_s:.2f} patches/s, waiting "
          f"on the loader {long_wait:.3f} s ({100 * long_wait / long_s:.1f}% of the epoch's host "
          f"time); the loader alone {long_loader_rate:.2f} patches/s; the train step alone "
          f"{step_rate:.2f} patches/s (bench.run_train, this run) [{smi}]", flush=True)
    print(f"[engine] the same {long_steps} steps from 4 decoded batches held in memory (no loader "
          f"running): {unloaded['epoch_time_s']:.3f} s, "
          f"{long_steps * BATCH / unloaded['epoch_time_s']:.2f} patches/s, "
          f"{1e3 * (unloaded['epoch_time_s'] - unloaded['data_wait_s']) / long_steps:.1f} ms a step "
          f"outside the wait (timed epoch: "
          f"{1e3 * (long_s - long_wait) / long_steps:.1f}) [{smi}]", flush=True)
    print(f"[engine] device busy {prof['kernel_ms'] / steps:.2f} ms a step (torch.profiler, 2 "
          f"{steps}-step epochs): {busy:.1f} ms of the {1e3 * long_s:.1f} ms timed epoch (idle "
          f"{100 * max(0.0, 1 - busy / (1e3 * long_s)):.1f}%) [{smi}]", flush=True)
    return {"epochs": epochs, "loader_rate": loader_rate, "peak_gib": peak}


# the packed-feed phase: a synthetic train split of PACK_SAMPLES packed in
# float16, and the 4-step b128 epoch fed from the decoded source and from
# the pack, by decode processes (the Loader's) and by decode threads (20
# steps before the zoo phase joined the script, 12 before the CLI pool, 6
# before the diffusion phase, all within the script's time limit)
PACK_SAMPLES = 512
PACK_RECORD_BYTES = 702472  # 3 x 224 x 224 x 2 float16, mask and valid int8, clz, activation
FEED_SEED = 11


class ThreadRows:
    """The other arm of the loader's A/B: decode threads in this process
    writing the same ring rows that the Loader's decode processes write."""

    def __init__(self, decoder, ring, workers: int):
        from concurrent.futures import ThreadPoolExecutor

        self.decoder, self.ring = decoder, ring
        self.pool = ThreadPoolExecutor(max_workers=workers)

    def fill(self, slot: int, ids):
        futures = [self.pool.submit(self.decoder.fill, self.ring.arrays[slot], row, int(i))
                   for row, i in enumerate(ids)]
        return lambda: [f.result() for f in futures]

    def close(self) -> None:
        self.pool.shutdown()


def feed_arm(torch, engine, cfg: dict, threads: bool) -> dict:
    """One arm of the feed: a fresh train Loader (decode threads or
    processes) started and page-locked, the loader alone over one epoch
    (batch 0 kept), then one engine epoch of the same split."""
    from kurosiwo_torch.data.pipeline import Loader

    cls = type("ThreadLoader", (Loader,), {"worker_class": ThreadRows}) if threads else Loader
    loader = cls("train", cfg, FEED_SEED)
    try:
        t0 = time.perf_counter()
        loader._start()
        loader._ring.pin()
        start_s = time.perf_counter() - t0
        first, n = None, 0
        t0 = time.perf_counter()
        for b in loader.ring_batches(pin=True):
            if first is None:
                first = {k: v.copy() for k, v in b.items()}
            n += len(b["mask"])
            b.release()
        alone = n / (time.perf_counter() - t0)
        summary = engine.run_train_epoch(loader, 0)
    finally:
        loader.close()
    steps = summary["batches"]
    require(steps == PACK_SAMPLES // BATCH and math.isfinite(summary["mean_loss"]),
            f"feed epoch ran {steps} steps, loss {summary['mean_loss']}")
    return {"start_s": start_s, "alone": alone, "first": first, "epoch_s": summary["epoch_time_s"],
            "wait_s": summary["data_wait_s"], "steps": steps}


def phase_packed_feed(torch, counters, smi: str, step_rate: float) -> dict:
    """A synthetic split of PACK_SAMPLES at 224^2 packed in float16 (the
    port's pack_split) into a temporary directory, read back from the warm
    page cache (it was just written; a cold read is not measured); then,
    for the decoded source and the pack, the 4-step b128 epoch of one
    engine, the loader alone, the step's host time outside the wait, by
    decode processes and by decode threads (in the order pack processes,
    pack threads, decoded processes, decoded threads). Batch 0 must be bitwise the
    same in both arms of a source, and the pack's that of the plain decode
    stacked. Then the card's busy time a step and its idle share of each
    epoch, and the peak memory."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np

    from kurosiwo_torch import bench
    from kurosiwo_torch.config import load_config
    from kurosiwo_torch.data.pipeline import Loader, epoch_rng
    from kurosiwo_torch.data.shards import ShardReader, pack_split
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.engine import TaskEngine, device_prefetch

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="kurosiwo-pack-"))
    try:
        cfg = load_config(method="unet", backbone="resnet18", config_root=root / "configs",
                          overrides={"synthetic_size": PACK_SAMPLES})
        mcfg = cfg["model_config"]
        t0 = time.perf_counter()
        source = Loader("train", cfg, FEED_SEED)
        packed = pack_split(source, tmp / "train", img_dtype="float16", workers=8)
        pack_s = time.perf_counter() - t0
        shards = sorted((tmp / "train").glob("shard_*.bin"))
        nbytes = sum(f.stat().st_size for f in shards)
        require(packed == PACK_SAMPLES and nbytes == PACK_SAMPLES * PACK_RECORD_BYTES,
                f"packed {packed} samples in {nbytes} bytes")
        packed_cfg = dict(cfg, packed_shards=str(tmp))

        torch.cuda.reset_peak_memory_stats()
        engine = TaskEngine(initialize_segmentation_model(cfg, mcfg, seed=FEED_SEED), cfg, mcfg,
                            "segmentation", steps_per_epoch=PACK_SAMPLES // BATCH)
        held = [b for _, b in zip(range(2), source)]
        source.close()
        engine.run_train_epoch(held, 0)  # warm-up
        # the same steps with no loader running: 2 decoded batches held in
        # memory, each taken 3 times
        unloaded = engine.run_train_epoch(held * (PACK_SAMPLES // BATCH // 2), 0)
        arms = {}
        order = [("pack", False), ("pack", True), ("decoded", False), ("decoded", True)]
        for src, threads in order:
            arm = feed_arm(torch, engine, packed_cfg if src == "pack" else cfg, threads)
            arms.setdefault((src, threads), []).append(arm)

        # batch 0 of every arm of a source is the same; the pack's is the
        # plain decode of its records, stacked
        for src in ("pack", "decoded"):
            a, b = arms[(src, False)][0]["first"], arms[(src, True)][0]["first"]
            require(a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a),
                    f"{src}: batch 0 of the decode processes differs from the threads'")
        reader = ShardReader(tmp / "train")
        plain = Loader("train", packed_cfg, FEED_SEED)
        require(plain.shard_reader is not None and len(reader) == PACK_SAMPLES, "pack not used")
        ids = epoch_rng(FEED_SEED, "train").permutation(PACK_SAMPLES)[:BATCH]
        samples = [plain.decoder.process(plain.records[int(i)]) for i in ids]
        want = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        got = arms[("pack", False)][0]["first"]
        require(got.keys() == want.keys() and all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want),
            "pack: batch 0 is not the plain decode of its records")

        # the card's busy time a train step, from one device-resident batch
        batch = next(device_prefetch(held[:1], engine.device))
        ms = MetricState.create(engine.device)

        def one():
            engine._train_step(engine.state, batch, ms, 1e-3, engine.generator)

        prof = bench.profile(one, 5, engine.device, 1e3 * BATCH / step_rate)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    busy = prof["kernel_ms"]
    print(f"[feed] packed {PACK_SAMPLES} synthetic 224^2 samples in float16: {nbytes} bytes "
          f"({nbytes / PACK_SAMPLES:.0f} a record) in {pack_s:.1f} s; read back from the warm "
          f"page cache (just written; a cold read is not measured) [{smi}]", flush=True)
    out = {}
    for (src, threads), runs in arms.items():
        for r in runs:
            rate = r["steps"] * BATCH / r["epoch_s"]
            host = 1e3 * (r["epoch_s"] - r["wait_s"]) / r["steps"]
            idle = 100 * max(0.0, 1 - busy * r["steps"] / (1e3 * r["epoch_s"]))
            print(f"[feed] {src} source, decode {'threads' if threads else 'processes'}: "
                  f"{r['steps']}-step b{BATCH} epoch {r['epoch_s']:.3f} s, {rate:.2f} patches/s, "
                  f"waiting {r['wait_s']:.3f} s ({100 * r['wait_s'] / r['epoch_s']:.1f}%), "
                  f"the step's host time outside the wait {host:.1f} ms a step, card idle "
                  f"{idle:.1f}%; the loader alone {r['alone']:.2f} patches/s (start-up "
                  f"{r['start_s']:.2f} s, not in it) [{smi}]", flush=True)
            out.setdefault(f"{src}_{'threads' if threads else 'processes'}", []).append(
                {"patches_s": rate, "alone": r["alone"], "host_ms": host, "idle": idle})
    print(f"[feed] the same {unloaded['batches']} steps with no loader running (2 batches "
          f"held in memory): {unloaded['epoch_time_s']:.3f} s, "
          f"{unloaded['batches'] * BATCH / unloaded['epoch_time_s']:.2f} patches/s, "
          f"{1e3 * (unloaded['epoch_time_s'] - unloaded['data_wait_s']) / unloaded['batches']:.1f}"
          f" ms a step outside the wait [{smi}]", flush=True)
    print(f"[feed] device busy {busy:.2f} ms a step (torch.profiler, 5 steps); the train step "
          f"alone {step_rate:.2f} patches/s (bench.run_train, this run); peak "
          f"{peak:.2f} GiB; batch 0 bitwise equal across arms and to the plain decode [{smi}]",
          flush=True)
    return out


def _host(x):
    """A nest of draws (dicts, lists, tensors) with every tensor on the CPU."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_host(v) for v in x]
    return x.cpu()


AUG_EVERY = {  # every operation of the pipeline at p = 1
    "RandomResizedCrop": {"value": 224, "scale": [0.2, 1.0], "p": 1.0},
    "GaussianBlur": {"sigma_limit": [0.1, 2.0], "p": 1.0},
    "HorizontalFlip": {"p": 1.0},
    "VerticalFlip": {"p": 1.0},
    "ElasticTransform": {"alpha": "1.0", "sigma": 50, "alpha_affine": 50, "p": 1.0},
    "GaussNoise": {"p": 1.0},
    "MultNoise": {"p": 1.0},
    "Cutout": {"p": 1.0},
}


def aug_batch(b: int, seed: int) -> dict:
    """A b x 224^2 batch with a border of invalid pixels in each sample and
    one sample whose valid mask is almost empty (a crop may lose it)."""
    import numpy as np

    from kurosiwo_torch import bench

    batch = bench.host_batch(b, seed=seed)
    rs = np.random.RandomState(seed)
    for i in range(b):
        batch["valid"][i, :rs.randint(0, 40)] = 0
    batch["valid"][0] = 0
    batch["valid"][0, 5:9, 5:9] = 1
    batch["mask"] = np.where(batch["valid"] == 1, batch["mask"], 3).astype(np.int32)
    return batch


def phase_augment(torch, counters, smi: str) -> None:
    """augment_batch's applies on the card against the CPU's with the same
    draws (drawn on the card), at b8 224^2: the shipped
    configs/augmentations/augmentation.json and every operation at p = 1.
    Images within 1e-4, masks equal; then the b128 augmented train step's
    rate beside the plain step's (in the order plain, augmented, augmented,
    plain), and augment_batch alone at b128 (CUDA events)."""
    from pathlib import Path

    from kurosiwo_torch import bench
    from kurosiwo_torch.config import load_json5
    from kurosiwo_torch.data import augment

    root = Path(__file__).resolve().parent
    shipped = load_json5(root / "configs" / "augmentations" / "augmentation.json")["augmentations"]
    host = aug_batch(8, 3)
    for name, aug in (("shipped", shipped), ("every operation at p=1", AUG_EVERY)):
        cfg = {"augmentations": aug}
        card = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        g = torch.Generator("cuda").manual_seed(0)
        draws = augment.draw_augmentations(g, card, cfg)
        got = augment.apply_augmentations(card, cfg, draws)
        want = augment.apply_augmentations({k: torch.from_numpy(v) for k, v in host.items()},
                                           cfg, _host(draws))
        img_err = max((got[k].cpu() - want[k]).abs().max().item() for k in ("post", "pre1", "pre2"))
        mask_diff = sum(int((got[k].cpu() != want[k]).sum()) for k in ("mask", "valid"))
        kept = int((want["valid"].sum(dim=(1, 2)) > 0).sum())
        require(img_err <= 1e-4 and mask_diff == 0,
                f"augment {name}: card vs CPU images {img_err:.2e}, {mask_diff} mask pixels differ")
        require(all(torch.isfinite(got[k]).all() for k in ("post", "pre1", "pre2")),
                f"augment {name}: non-finite images")
        print(f"[augment] {name} ({', '.join(draws)}), b8 224^2, card vs CPU with the card's "
              f"draws: images max abs err {img_err:.2e}, mask pixels differing {mask_diff}, "
              f"samples with valid pixels {kept}/8 [{smi}]", flush=True)

    big = {k: torch.from_numpy(v).cuda() for k, v in aug_batch(BATCH, 4).items()}
    g = torch.Generator("cuda").manual_seed(1)
    aug_ms = event_ms(torch, lambda: augment.augment_batch(g, big, {"augmentations": shipped}),
                      reps=3, calls=5)
    del big
    plain = bench.setup(BATCH)
    augmented = bench.setup(BATCH, overrides={"data_augmentations": True,
                                              "augmentations": shipped})
    rates = {}
    for tag, b in (("plain", plain), ("augmented", augmented), ("augmented", augmented),
                   ("plain", plain)):
        zero_counters(counters)
        seconds, loss, metric = bench.run_train(b, 10, 3)
        launches = read_counters(counters)
        require(bool(torch.isfinite(loss).item()), f"{tag} train loss {loss.item()}")
        want = {name: 0 for name in counters} | {"pair_sums": 60 * 13, "ce_cm_fwd_nhwc": 13,
                                                 "ce_cm_bwd_nhwc": 13}
        require(launches == want, f"{tag} train launches {launches}")
        rates.setdefault(tag, []).append(10 * BATCH / seconds)
    del plain, augmented
    torch.cuda.empty_cache()
    print(f"[augment] b{BATCH} bf16 train step, shipped augmentations (RandomResizedCrop p=1, "
          f"HorizontalFlip p=0.5): {', '.join(f'{r:.2f}' for r in rates['augmented'])} "
          f"patches/s; the plain step in the same run {', '.join(f'{r:.2f}' for r in rates['plain'])}"
          f"; augment_batch alone {aug_ms:.3f} ms a b{BATCH} batch (CUDA events) [{smi}]",
          flush=True)


# the losses of create_loss other than cross entropy, and the zone banks
LOSS_CONFIGS = [("iou", {"loss_function": "iou"}), ("dice", {"loss_function": "dice"}),
                ("focal", {"loss_function": "focal"}), ("ce+dice", {"loss_function": "ce+dice"}),
                ("zones", {"log_zone_metrics": True})]


def phase_losses_zones(torch, counters, smi: str) -> None:
    """For each loss (iou, dice, focal, ce+dice) and for log_zone_metrics:
    one f32 train and eval step at (4, 64, 64, 6), card against CPU, with
    phase_parity's bands (the zone banks also summing to the main bank, and
    their cells within 0.1% of the valid pixels); then the b128 bf16 train
    step and the f32-twin eval step on the card: 60 pair_sums a train step,
    no CE+cm kernel (these configs turn the fused tail off), and their
    rates."""
    from kurosiwo_torch import bench

    for name, over in LOSS_CONFIGS:
        cfg = dict(bench.build_config("unet", 4), mixed_precision=False, **over)
        res = card_and_cpu_steps(torch, counters, cfg)
        c, g, valid = res["cpu"], res["cuda"], res["valid"]
        for key in ("loss", "eloss"):
            require(abs(g[key] - c[key]) <= 1e-4 * abs(c[key]),
                    f"{name} {key}: card {g[key]} vs CPU {c[key]}")
        for key in ("cm", "ecm"):
            require(torch.equal(g[key].sum(1), c[key].sum(1)), f"{name} {key} row sums")
            require((g[key] - c[key]).abs().max().item() <= 1e-3 * valid, f"{name} {key} cells")
        for key, cm in (("zones", "cm"), ("ezones", "ecm")):
            if name == "zones":
                for r in (c, g):
                    require(torch.equal(r[key].sum(0), r[cm]) and (r[key].sum((1, 2)) > 0).all(),
                            f"zone banks ({key}) do not sum to the main bank")
                require((g[key] - c[key]).abs().max().item() <= 1e-3 * valid, f"{key} cells")
            else:
                require(not g[key].any() and not c[key].any(), f"{name}: zone banks filled")
        pmax, pshare = adam_step_close({k: g["state"][k] for k in res["params"]},
                                       {k: c["state"][k] for k in res["params"]}, 1e-3)
        require(pmax <= 2e-3 + 1e-6 and pshare >= 0.99, f"{name} params: max {pmax}, {pshare}")
        print(f"[losses] {name} f32 (4,64,64,6) card vs CPU: loss {g['loss']:.6f} vs "
              f"{c['loss']:.6f}, eval loss {g['eloss']:.6f} vs {c['eloss']:.6f}, cm max diff "
              f"{(g['cm'] - c['cm']).abs().max().item():.0f} of {valid} px, params max {pmax:.2e} "
              f"({pshare * 100:.2f}% within 3e-4)", flush=True)

    warmup, steps = 2, 5
    n = warmup + steps
    for name, over in LOSS_CONFIGS:
        b = bench.setup(BATCH, overrides=over)
        zero_counters(counters)
        seconds, loss, metric = bench.run_train(b, steps, warmup)
        launches = read_counters(counters)
        require(bool(torch.isfinite(loss).item()), f"{name} b{BATCH} train loss {loss.item()}")
        require(launches == {k: 0 for k in counters} | {"pair_sums": 60 * n},
                f"{name} b{BATCH} train launches {launches}")
        require(bank_counts_all(metric, n * int((b.batch["mask"] != 3).sum().item())),
                f"{name} b{BATCH} train bank count")
        train_rate = steps * BATCH / seconds
        zero_counters(counters)
        seconds, eloss, _ = bench.run_eval(b, steps, warmup, f32=True)
        require(bool(torch.isfinite(eloss).item()) and read_counters(counters) == {
            k: 0 for k in counters}, f"{name} b{BATCH} eval: loss {eloss.item()}, launches "
                                     f"{read_counters(counters)}")
        print(f"[losses] {name} b{BATCH}: train bf16 {train_rate:.2f} patches/s (loss "
              f"{loss.item():.5f}, 60 pair_sums a step, no CE+cm kernel), eval f32 twin "
              f"{steps * BATCH / seconds:.2f} patches/s [{smi}]", flush=True)
        del b
        torch.cuda.empty_cache()


# the change-detection phase's small card-against-CPU steps: (method, batch,
# side); SNUNet at base_channel 8, Siam at 36 so that its replication pad
# acts, HFA-Net at the one side it fits
CD_SMALL = (("snunet", 2, 64), ("siam-diff", 2, 36), ("siam-conc", 2, 36), ("adhr-cdnet", 2, 32),
            ("hfa-net", 1, 224))
CD_WIDTH = {"base_channel": 8}


def cd_config(method: str, batch: int, **kw) -> dict:
    from kurosiwo_torch import bench

    return dict(bench.build_config("snunet", batch), method=method, **kw)


def cd_batch(torch, batch: int, side: int, seed: int = 1) -> dict:
    from kurosiwo_torch import bench

    host = bench.host_batch(batch, side, seed=seed)
    return {k: torch.from_numpy(v) for k, v in host.items()}


def cd_step_on(torch, counters, model, cfg: dict, mc: dict, batch: dict, device: str,
               masks: list, task: str = "cd"):
    """One train step of ``model`` on ``device``; the Dropout2d and DropPath
    masks are drawn there and recorded into ``masks`` (card) or replayed
    from it (CPU). Returns the loss, bank, state after the step, the
    optimizer's first moment or momentum buffer (``sgd``: which), the step's
    kernel launches and the plain calls of the pair-sum and short-attention
    wrappers (the CPU's)."""
    from kurosiwo_torch.ops import batchnorm
    from kurosiwo_torch.ops import nn as tnn
    from kurosiwo_torch.ops import short_attention as sa
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.state import create_train_state
    from kurosiwo_torch.training.steps import make_train_step

    draw = tnn._MaskedDrop.draw_mask
    plains = {"pair_sums": (batchnorm, "pair_sums_plain"),
              "short_attention_fwd": (sa, "short_attention_fwd_plain"),
              "short_attention_bwd": (sa, "short_attention_bwd_plain")}
    real = {k: getattr(mod, name) for k, (mod, name) in plains.items()}
    plain = dict.fromkeys(plains, 0)

    def card_mask(self, x, g):
        m = draw(self, x, g)
        masks.append(m.cpu())
        return m

    def counting(key):
        def call(*a):
            plain[key] += 1
            return real[key](*a)
        return call

    tnn._MaskedDrop.draw_mask = card_mask if device == "cuda" else (
        lambda self, x, g: masks.pop(0))
    for k, (mod, name) in plains.items():  # the CPU's calls of the plain versions
        setattr(mod, name, counting(k))
    try:
        state = create_train_state(model, cfg, mc, "cd" if task == "cd" else "segmentation")
        step = make_train_step(model, create_loss(cfg, "train"), cfg, mc, task=task,
                               device=device)
        zero_counters(counters)
        state, ms, loss = step(state, batch, MetricState.create(device), 1e-3,
                               torch.Generator(device).manual_seed(0))
        launched = read_counters(counters)
    finally:
        tnn._MaskedDrop.draw_mask = draw
        for k, (mod, name) in plains.items():
            setattr(mod, name, real[k])
    sgd = isinstance(state.optimizer, torch.optim.SGD)
    key = "momentum_buffer" if sgd else "exp_avg"
    moment = torch.cat([state.optimizer.state[p][key].detach().cpu().reshape(-1)
                        for p in model.parameters()])
    return dict(loss=loss.item(), cm=ms.cm.cpu(),
                state={k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                moment=moment, sgd=sgd, launched=launched, plain_calls=plain)


def cd_eval(torch, model, cfg: dict, mc: dict, batch: dict, weights: dict, task: str = "cd"):
    """The eval step's loss and cm of ``model`` with ``weights`` loaded."""
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.steps import make_eval_step

    model.load_state_dict(weights)
    dev = next(model.parameters()).device
    ev = make_eval_step(model, create_loss(cfg, "val"), cfg, mc, task=task, device=dev)
    ms, loss, _ = ev(None, batch, MetricState.create(dev))
    return loss.item(), ms.cm.cpu()


def cd_card_vs_cpu(torch, counters, tag: str, method: str, mc: dict, bsz: int,
                   side: int, task: str = "cd", keys: dict | None = None) -> dict:
    """One f32 train step of a change-detection method on the card
    (kernels) against the same on the CPU (plain versions), from the same
    weights and batch, the card's Dropout2d and DropPath masks replayed on
    the CPU, deterministic algorithms on; then the eval step of both from
    the CPU's trained weights. Bands as tests/test_torch_cd_steps.py (card
    against CPU in place of JAX against torch): loss rtol 1e-4; cm row sums
    equal, cells within 0.1% of the valid pixels; the optimizer's first
    moment (Adam) or momentum buffer (SGD, which HFA-Net and BiT-CD are
    forced to) within 2% in L2; Adam's parameters all within 2*lr and 99%
    within 3e-4, SGD's within 1e-4 (lr times a tenth of a gradient); batch
    statistics atol 1e-4. The card's train step launches the pair-sum and
    short-attention kernels once for each plain call of the CPU's. With
    ``task="segmentation"`` the model is the segmentation factory's on the
    bench's UNet config with ``keys``, fed the 6-channel image, and where it
    misses the gradient, parameter-share or statistics band, the bands widen
    to twice what the CPU step itself moves under a 1e-6 normal change of
    the images (a train-mode Bottleneck trunk's conditioning), the
    printed band. With ``task="recurrent"`` the model is the ConvLSTM on
    the bench's config (three frames of 2 channels). Returns the card
    step's launches."""
    from kurosiwo_torch import bench
    from kurosiwo_torch.device import configure_backends
    from kurosiwo_torch.models.factory import initialize_cd_model, initialize_segmentation_model

    if task == "cd":
        cfg = cd_config(method, bsz, mixed_precision=False, synthetic_patch_size=side)
        cpu_model = initialize_cd_model(cfg, mc, device="cpu", seed=3)
    elif task == "recurrent":
        from kurosiwo_torch.models.factory import initialize_recurrent_model

        cfg = dict(bench.build_config(method, bsz), mixed_precision=False,
                   synthetic_patch_size=side, **(keys or {}))
        cpu_model = initialize_recurrent_model(cfg, mc, device="cpu", seed=3)
    else:
        cfg = dict(bench.build_config(method, bsz), mixed_precision=False,
                   synthetic_patch_size=side, **(keys or {}))
        cpu_model = initialize_segmentation_model(cfg, mc, device="cpu", seed=3)
    configure_backends(cfg, "cuda")
    batch = cd_batch(torch, bsz, side)
    masks: list = []
    card_model = copy.deepcopy(cpu_model).to("cuda")
    g = cd_step_on(torch, counters, card_model, cfg, mc, batch, "cuda", masks, task)
    drawn = len(masks)
    # the CPU step's own movement under a 1e-6 change of the images is the
    # conditioning floor of the gradient, parameter and statistics bands of a
    # segmentation model (no dropout) that misses them: resnet50's train-mode
    # trunk moves its gradient by 3.5-4.4% in L2 under it
    start = copy.deepcopy(cpu_model) if task == "segmentation" else None
    c = cd_step_on(torch, counters, cpu_model, cfg, mc, batch, "cpu", masks, task)
    # the eval step of both from the CPU's trained weights: the same function
    for r, model in ((g, card_model), (c, cpu_model)):
        r["eloss"], r["ecm"] = cd_eval(torch, model, cfg, mc, batch, c["state"], task)
    valid = int((batch["mask"] != 3).sum())
    for key in ("loss", "eloss"):
        require(abs(g[key] - c[key]) <= 1e-4 * abs(c[key]),
                f"cd {tag} {key}: card {g[key]} vs CPU {c[key]}")
    for key in ("cm", "ecm"):
        require(torch.equal(g[key].sum(1), c[key].sum(1)), f"cd {tag} {key} row sums")
        require((g[key] - c[key]).abs().max().item() <= 1e-3 * valid, f"cd {tag} {key} cells")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    l2 = rel(g["moment"], c["moment"])
    params = [k for k, _ in cpu_model.named_parameters()]
    stats = [k for k in c["state"] if k not in params]
    l2_band, share_band = 2e-2, 0.99
    pmax, pshare = adam_step_close({k: g["state"][k] for k in params},
                                   {k: c["state"][k] for k in params}, 1e-3)
    smax = max([(g["state"][k] - c["state"][k]).abs().max().item() for k in stats] + [0.0])
    noisy = None
    if start is not None and (l2 > l2_band or pshare < share_band or smax > 1e-4):
        gen = torch.Generator().manual_seed(5)
        nb = {k: v + 1e-6 * torch.randn(v.shape, generator=gen) if k in ("post", "pre1", "pre2")
              else v for k, v in batch.items()}
        noisy = cd_step_on(torch, counters, start, cfg, mc, nb, "cpu", [], task)
        _, noisy_share = adam_step_close({k: noisy["state"][k] for k in params},
                                         {k: c["state"][k] for k in params}, 1e-3)
        l2_band = max(l2_band, 2 * rel(noisy["moment"], c["moment"]))
        share_band = min(share_band, noisy_share - 0.01)
    require(l2 <= l2_band, f"cd {tag} gradients: relative L2 {l2} (band {l2_band})")
    sgd = c["sgd"]
    require(pmax <= (1e-4 if sgd else 2e-3 + 1e-6) and (sgd or pshare >= share_band),
            f"cd {tag} params: max {pmax}, share {pshare} (band {share_band})")
    s_band = 1e-4 if noisy is None else max([1e-4] + [
        2 * (noisy["state"][k] - c["state"][k]).abs().max().item() for k in stats])
    require(smax <= s_band, f"cd {tag} batch stats: {smax} (band {s_band})")
    launched = g["launched"]
    require(launched == {k: 0 for k in counters} | c["plain_calls"],
            f"cd {tag} card train step launched {launched}, the CPU step made the plain calls "
            f"{c['plain_calls']}")
    shape = {"cd": f"({bsz},{side},{side},2)x2", "recurrent": f"({bsz},3,{side},{side},2)"}.get(
        task, f"({bsz},{side},{side},6)")
    label = {"cd": "cd", "recurrent": "recurrent"}.get(task, "seg-zoo")
    print(f"[{label} parity] {tag} f32 {shape} card vs CPU: loss "
          f"{g['loss']:.6f} vs {c['loss']:.6f}, eval loss {g['eloss']:.6f} vs "
          f"{c['eloss']:.6f}, cm max diff {(g['cm'] - c['cm']).abs().max().item():.0f} of "
          f"{valid} px, {'SGD buffer' if sgd else 'Adam moment'} rel L2 {l2:.2e} (band "
          f"{l2_band:.2e}), params "
          f"max {pmax:.2e}, batch stats max {smax:.2e}, {drawn} masks drawn "
          f"({len(masks)} left over), launches a step "
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    require(not masks, f"cd {tag}: the CPU step drew fewer masks than the card's")
    return launched


def phase_cd_parity(torch, counters) -> dict:
    """Each of the five convolutional change-detection methods through
    ``cd_card_vs_cpu`` (Adam at lr 1e-3; HFA-Net forced to SGD). Returns
    {method: pair-sum launches}."""
    out = {}
    for method, bsz, side in CD_SMALL:
        mc = dict(CD_WIDTH, optimizer="adam", learning_rate=1e-3)
        out[method] = cd_card_vs_cpu(torch, counters, method, method, mc, bsz, side)["pair_sums"]
    return out


def phase_cd_remat(torch, counters) -> None:
    """remat on against off on the card, one f32 train step from the same
    weights, batch and generator seed: SNUNet's column plan (base_channel
    8, b2 64^2) and Siam-diff's whole-forward region with dropout on (b2
    36^2). Required: the BN running statistics equal after the step, the
    optimizer's moments within the f32 band (rel L2 1e-5), the pair-sum
    launches equal."""
    from kurosiwo_torch.models.factory import initialize_cd_model

    for method, side in (("snunet", 64), ("siam-diff", 36)):
        cfg = cd_config(method, 2, mixed_precision=False)
        mc = dict(CD_WIDTH, optimizer="adam", learning_rate=1e-3)
        base = initialize_cd_model(cfg, mc, device="cpu", seed=5)
        batch = cd_batch(torch, 2, side, seed=2)
        runs = {}
        for remat in (False, True):
            model = copy.deepcopy(base).to("cuda")
            if method == "snunet":
                model.remat = remat
            masks: list = []
            runs[remat] = cd_step_on(torch, counters, model, dict(cfg, remat=remat), mc, batch,
                                     "cuda", masks)
        a, b = runs[False], runs[True]
        params = {k for k, _ in base.named_parameters()}
        stats_equal = all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"]
                          if k not in params)
        l2 = ((a["moment"] - b["moment"]).norm() / a["moment"].norm()).item()
        bitwise = all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
        require(stats_equal, f"cd remat {method}: running statistics differ")
        require(l2 <= 1e-5, f"cd remat {method}: gradients differ, rel L2 {l2}")
        require(a["launched"] == b["launched"],
                f"cd remat {method}: launches {a['launched']} without, {b['launched']} with")
        print(f"[cd remat] {method} on the card, remat off vs on: loss {a['loss']:.6f} vs "
              f"{b['loss']:.6f}, running statistics equal, moments rel L2 {l2:.1e} "
              f"({'bitwise equal' if bitwise else 'not bitwise'}), pair_sums "
              f"{a['launched']['pair_sums']} vs {b['launched']['pair_sums']} a step", flush=True)


@contextlib.contextmanager
def recording_bn_shapes(shapes: set):
    """While active, adds the shape of every card tensor the BatchNorms hand
    pair_sums to ``shapes`` (at its CUDA path, under the wrapper that counts
    the launches)."""
    from kurosiwo_torch.ops import batchnorm

    real = batchnorm._pair_sums_cuda

    def recording(a, b):
        shapes.add(tuple(a.shape))
        return real(a, b)

    batchnorm._pair_sums_cuda = recording
    try:
        yield
    finally:
        batchnorm._pair_sums_cuda = real


ATTN_WRAPPERS = ("short_attention_fwd", "short_attention_bwd")


@contextlib.contextmanager
def recording_attention_shapes(shapes):
    """While active, counts in ``shapes`` (a Counter) every card call of the
    short-attention forward wrapper by (B, Nq, Nk, H*D, H) (at its launch,
    under the wrapper that counts)."""
    from kurosiwo_torch.ops import short_attention as sa

    real = sa.launch_fwd

    def recording(plan, q, k, v, heads, scale):
        shapes[(q.shape[0], q.shape[1], k.shape[1], q.shape[2], heads)] += 1
        return real(plan, q, k, v, heads, scale)

    sa.launch_fwd = recording
    try:
        yield
    finally:
        sa.launch_fwd = real


def cd_timed(torch, counters, smi: str, model: str, batch: int, overrides: dict,
             warmup: int, steps: int, eval_too: bool = False, profile_steps: int = 3,
             eval_steps: tuple[int, int] | None = None,
             bn_shapes: set | None = None, model_config: dict | None = None,
             attn_shapes=None, tag: str | None = None, label: str = "cd main") -> dict:
    """``steps`` timed bf16 train steps (after ``warmup``) of a
    change-detection bench leg at ``batch`` (``model_config`` over the bench's):
    patches/s, peak memory, pair-sum and short-attention launches a step
    (the latter by kernel) and the card's busy time a step (torch.profiler);
    with ``eval_too`` the f32-twin eval step too (``eval_steps``: its
    (warm-up, timed) steps, default the train's). The shapes of the train
    step's BatchNorm inputs are added to ``bn_shapes``, its short-attention
    calls counted in ``attn_shapes``."""
    import collections

    from kurosiwo_torch import bench

    tag = tag or model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = bench.setup(batch, overrides=overrides, model=model, model_config=model_config)
    zero_counters(counters)
    with recording_bn_shapes(set() if bn_shapes is None else bn_shapes), \
            recording_attention_shapes(collections.Counter() if attn_shapes is None
                                       else attn_shapes):
        seconds, loss, metric = bench.run_train(b, steps, warmup)
    launches = read_counters(counters)
    by_kernel = {k: v for k, v in read_kernel_counters(counters).items()
                 if k.startswith(ATTN_WRAPPERS) and v}
    n = warmup + steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(bool(torch.isfinite(loss).item()), f"{tag} b{batch} train loss {loss.item()}")
    valid = int((b.batch["mask"] != 3).sum().item())
    require(bank_counts_all(metric, n * valid), f"{tag} b{batch} train bank count")
    require(all(launches[k] % n == 0 for k in ("pair_sums",) + ATTN_WRAPPERS) and all(
        v == 0 for k, v in launches.items() if k not in ("pair_sums",) + ATTN_WRAPPERS),
        f"{tag} b{batch} train launches {launches}")
    from kurosiwo_torch.ops.batchnorm import BatchNorm

    out = {"rate": steps * batch / seconds, "ms": seconds / steps * 1e3, "peak_gib": peak,
           "pair_sums": launches["pair_sums"] // n, "batch": batch,
           "batchnorms": sum(isinstance(m, BatchNorm) for m in b.state.model.modules()),
           "remat": bool(b.config.get("remat", getattr(b.state.model, "remat", False)))}
    if any(launches[k] for k in ATTN_WRAPPERS):
        out["short_attention"] = {k: v // n for k, v in by_kernel.items()}
    out["busy_ms"] = math.nan
    if profile_steps:
        one, _ = bench._train_fn(b)
        prof = bench.profile(one, profile_steps, b.device, out["ms"], file=sys.stdout)
        out["busy_ms"] = prof["kernel_ms"]
    attn = f", short_attention a step {out['short_attention']}" if "short_attention" in out else ""
    print(f"[{label}] {tag} train b{batch} bf16 (remat {'on' if out['remat'] else 'off'}"
          f"{', ' + json.dumps(overrides) if overrides else ''}): "
          f"{out['rate']:.2f} patches/s ({out['ms']:.2f} ms/step), loss {loss.item():.5f}, "
          f"peak {peak:.2f} GiB, pair_sums {out['pair_sums']} a step{attn}, device busy "
          f"{out['busy_ms']:.2f} ms/step [{smi}]", flush=True)
    if eval_too:
        ewarm, esteps = eval_steps or (warmup, steps)
        en = ewarm + esteps
        torch.cuda.reset_peak_memory_stats()
        zero_counters(counters)
        seconds, eloss, emetric = bench.run_eval(b, esteps, ewarm, f32=True)
        elaunch = read_counters(counters)  # eval: attention forwards only (f32: simt)
        require(bool(torch.isfinite(eloss).item()) and elaunch["short_attention_fwd"] % en == 0
                and all(v == 0 for k, v in elaunch.items() if k != "short_attention_fwd"),
                f"{tag} eval: loss {eloss.item()}, launches {elaunch}")
        require(bank_counts_all(emetric, en * valid), f"{tag} b{batch} eval bank count")
        out["eval_rate"] = esteps * batch / seconds
        out["eval_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{label}] {tag} eval b{batch} f32 twin: {out['eval_rate']:.2f} patches/s "
              f"({seconds / esteps * 1e3:.2f} ms/step), peak {out['eval_peak_gib']:.2f} GiB "
              f"[{smi}]", flush=True)
    del b
    torch.cuda.empty_cache()
    return out


def cd_fitting(torch, counters, smi: str, model: str, bn_shapes: set) -> dict:
    """The bf16 train step of a model at b64, or b32 if that does not fit,
    timed at 2 + 5 steps. HFA-Net and ADHR-CDNet run out of memory at b128
    (PERF.md; ``python3 -m kurosiwo_torch.bench --model hfa-net --batch 128``
    tries it), so the search starts at b64. (A whole-forward remat would not
    lower the peak: its backward recomputes every activation before it frees
    any.)"""
    import gc

    batches = (BATCH // 2, BATCH // 4)
    for batch in batches:
        try:
            return cd_timed(torch, counters, smi, model, batch, {}, 2, 5, profile_steps=2,
                            bn_shapes=bn_shapes)
        except torch.cuda.OutOfMemoryError:
            print(f"[cd main] {model} b{batch}: out of memory", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    raise PhaseFailed(f"{model}: no batch of {batches} fits")


def phase_cd_pair_sums(torch, shapes: set, label: str = "cd",
                       what: str = "CD train steps") -> dict:
    """B3 against its plain version at every BatchNorm input shape that the
    change-detection train steps above gave it (SNUNet and Siam-diff at
    b128, HFA-Net and ADHR-CDNet at the batch that fit), on random inputs
    in f32 and bf16, (x, x) and (dy, x), held to ``pair_sums_check``'s
    band."""
    from kurosiwo_torch.ops import batchnorm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    out = {"shapes": len(shapes), "max_abs_err": 0.0, "max_rel_err": 0.0}
    for shape in sorted(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, device=dev, generator=g).to(dtype)
            dy = torch.randn(shape, device=dev, generator=g).to(dtype)
            for a, b in ((x, x), (dy, x)):
                err, rel = pair_sums_check(torch, batchnorm, a, b, f"cd {shape} {dtype}")
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["max_rel_err"] = max(out["max_rel_err"], rel)
            del x, dy
        torch.cuda.empty_cache()
    big = max(shapes, key=math.prod)
    print(f"[{label} pair_sums] kernel vs plain at the {len(shapes)} BatchNorm input shapes of "
          f"the {what} (largest {big}, C from {min(x[-1] for x in shapes)} to "
          f"{max(x[-1] for x in shapes)}), f32 and bf16, (x,x) and (dy,x): max error "
          f"{out['max_abs_err']:.3e} absolute, {out['max_rel_err']:.3e} of the sum of |terms|; "
          "deterministic", flush=True)
    return out


def phase_cd_hfanet_bf16(torch, smi: str, batch: int = 8) -> float:
    """ROADMAP C18 on the card: HFA-Net's first-layer (encoder.pre_treat)
    gradient norm from one bf16 forward and backward against the f32 one,
    same weights and batch (224^2), required within 2x (a high-pass bank
    computed in bf16 gives 1e13 times). Returns bf16 over f32."""
    from kurosiwo_torch.models.factory import initialize_cd_model
    from kurosiwo_torch.ops.losses import create_loss

    batch_ = {k: v.cuda() for k, v in cd_batch(torch, batch, IMAGE).items()}
    weights = initialize_cd_model(cd_config("hfa-net", batch), {}, device="cpu",
                                  seed=3).state_dict()
    norms = {}
    for mp in (False, True):
        cfg = cd_config("hfa-net", batch, mixed_precision=mp)
        model = initialize_cd_model(cfg, {}, device="cpu", seed=3)
        model.load_state_dict(weights)
        model = model.to("cuda").train()
        out = model(batch_["pre1"], batch_["post"])
        create_loss(cfg, "train")(out, batch_["mask"]).backward()
        norms[mp] = model.encoder.pre_treat.weight.grad.norm().item()
        del model, out
        torch.cuda.empty_cache()
    ratio = norms[True] / norms[False]
    print(f"[cd hfa-net] b{batch} first-layer gradient norm: bf16 {norms[True]:.6e}, f32 "
          f"{norms[False]:.6e}, ratio {ratio:.4f} [{smi}]", flush=True)
    require(0.5 <= ratio <= 2.0, f"HFA-Net bf16 first-layer gradient {ratio} times the f32 one")
    return ratio


def fused_tail_step(torch, counters, model: str, batch: int, launches: dict, label: str):
    """One bf16 train step of a bench leg with ``fused_tail`` false, then
    true: the fused step launches B2 once each way besides ``launches``
    (and the plain step not at all), its loss within rtol 1e-5 of the plain
    tail's, its cm's row sums equal and cells within 0.1% of the valid
    pixels. Returns the fused step's launches and its Bench (after the
    step)."""
    from kurosiwo_torch import bench

    res = {}
    for fused in (False, True):
        b = bench.setup(batch, overrides={"fused_tail": fused}, model=model)
        zero_counters(counters)
        one, metric = bench._train_fn(b)
        res[fused] = (one().item(), metric[0].cm.cpu(), read_counters(counters))
        del one
        if not fused:
            del b
            torch.cuda.empty_cache()
    (lp, cmp_, lau_p), (lf, cmf, lau_f) = res[False], res[True]
    valid = int(cmp_.sum().item())
    require(lau_f == {k: 0 for k in counters} | launches | {"ce_cm_fwd_nhwc": 1,
                                                             "ce_cm_bwd_nhwc": 1},
            f"{model} fused-tail step launched {lau_f}")
    require(lau_p["ce_cm_fwd_nhwc"] == lau_p["ce_cm_bwd_nhwc"] == 0, "plain tail launched B2")
    require(abs(lf - lp) <= 1e-5 * abs(lp), f"{model} fused-tail loss {lf} vs plain {lp}")
    require(torch.equal(cmf.sum(1), cmp_.sum(1)) and (cmf - cmp_).abs().max().item()
            <= 1e-3 * valid, f"{model} fused-tail cm")
    lau_f = {k: v for k, v in lau_f.items() if v}
    print(f"[{label} fused_tail] {model} b{batch} bf16 step with fused_tail true: loss {lf:.6f} "
          f"vs plain tail {lp:.6f}, cm max diff {(cmf - cmp_).abs().max().item():.0f} of "
          f"{valid} px, launches {lau_f}", flush=True)
    return lau_f, b


def phase_cd(torch, counters, smi: str, cli: list) -> dict:
    """The change-detection slice: card against CPU for the five methods,
    remat on the card, the SNUNet b128 main path (remat on and off, the
    f32-twin eval), Siam-diff at b128, HFA-Net and ADHR-CDNet at the largest
    batch that fits, B3 against its plain version at every BatchNorm input
    shape those steps gave it, HFA-Net's bf16 gradient scale, one SNUNet
    b128 step with the fused CE + cm tail (B2) against the plain tail; adds
    to ``cli`` the CLI twice at one seed. Returns the numbers of each."""
    t0 = time.perf_counter()
    out = {"parity": phase_cd_parity(torch, counters)}
    phase_cd_remat(torch, counters)
    marks = {"parity": time.perf_counter() - t0}
    bn_shapes: set = set()
    # the legs at 2 warm-up and 5 timed steps, 2 profiled (3, 10 and 3 before
    # the zoo phase joined the script, within its time limit)
    out["snunet"] = cd_timed(torch, counters, smi, "snunet", BATCH, {}, 2, 5, eval_too=True,
                             bn_shapes=bn_shapes, profile_steps=2)
    out["snunet_no_remat"] = cd_timed(torch, counters, smi, "snunet", BATCH, {"remat": False},
                                      2, 5, profile_steps=2)
    # ROADMAP C14's question for cd: what deterministic algorithms cost the step
    out["snunet_autotuned"] = cd_timed(torch, counters, smi, "snunet", BATCH,
                                       {"deterministic": False}, 2, 5, profile_steps=0)
    print(f"[cd main] SNUNet b{BATCH} deterministic algorithms cost "
          f"{100 * (1 - out['snunet']['rate'] / out['snunet_autotuned']['rate']):.1f}% of the "
          f"autotuned step's rate in this run [{smi}]", flush=True)
    on, off = out["snunet"], out["snunet_no_remat"]
    require(on["remat"] and not off["remat"], "SNUNet b128 remat default")
    require(on["pair_sums"] == off["pair_sums"] == 76,
            f"SNUNet pair_sums a step {on['pair_sums']} (remat) and {off['pair_sums']}, "
            "expected 76 (38 BatchNorms, forward and backward)")
    require(on["peak_gib"] < off["peak_gib"],
            f"SNUNet peak memory with remat {on['peak_gib']:.2f} GiB not below "
            f"{off['peak_gib']:.2f} without")
    out["siam-diff"] = cd_timed(torch, counters, smi, "siam-diff", BATCH, {}, 2, 5,
                                bn_shapes=bn_shapes, profile_steps=2)
    require(out["siam-diff"]["pair_sums"] == 58, "Siam-diff pair_sums a step")
    for model in ("hfa-net", "adhr-cdnet"):
        out[model] = cd_fitting(torch, counters, smi, model, bn_shapes)
    marks["legs"] = time.perf_counter() - t0 - sum(marks.values())
    out["pair_sums_check"] = phase_cd_pair_sums(torch, bn_shapes)
    out["hfa_bf16_ratio"] = phase_cd_hfanet_bf16(torch, smi)

    # the fused CE + confusion-matrix tail (B2) on the SNUNet step, against the plain tail
    lau_f, b = fused_tail_step(torch, counters, "snunet", BATCH, {"pair_sums": 76}, "cd")
    del b
    torch.cuda.empty_cache()

    marks["checks"] = time.perf_counter() - t0 - sum(marks.values())

    # the CLI twice at one seed on the shipped configs with the cd task and two
    # inputs, as main.py takes them (deterministic by default for cd)
    inputs = ("--inputs", "pre_event_1", "post_event")
    cli.append(CliJob([({"on_screen_prints": True, "task": "cd"}, ("snunet",), inputs)] * 2,
                      lambda results: cli_pair_check("cd", "snunet", " ".join(inputs) + " ", smi,
                                                     results, note=' ("task": "cd")')))
    print(f"[cd] phase wall {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in marks.items())}; its CLI pair runs in the "
          f"CLI pool) [{smi}]", flush=True)
    out["fused_tail"] = lau_f
    return out


# the attention change-detection methods at a small size, card against CPU:
# (tag, method, model config, batch, side). At 64^2 BiT's decoder takes 256
# pixels against 4 tokens, ChangeFormer's stages 2 and 4 take 64 and 4
# queries against 4 reduced keys, TransUNet's ViT 17 tokens in 2 heads of 64
# (the short route at this width), all on B4's f32 (simt) kernels.
MULTI_WEIGHTS = [0.5, 0.5, 0.5, 0.8, 1.0]
TU_SMALL = {"out_channels": 16, "head_num": 2, "mlp_dim": 64, "block_num": 2}
CD_ATTN_SMALL = (
    ("bit-cd base_resnet18", "bit-cd", {"net_G": "base_resnet18"}, 2, 64),
    ("bit-cd base_transformer_pos_s4_dd8", "bit-cd", {"net_G": "base_transformer_pos_s4_dd8"},
     2, 64),
    ("changeformer multi_scale_train", "changeformer",
     {"embed_dim": 64, "multi_scale_train": True, "multi_pred_weights": MULTI_WEIGHTS}, 2, 64),
    ("transunet-cd", "transunet-cd", TU_SMALL, 2, 64),
    ("transunet-cd siamese", "transunet-cd", dict(TU_SMALL, siamese=True), 2, 64),
)
BIT_DD8 = {"net_G": "base_transformer_pos_s4_dd8"}


def phase_cd_attn_memory(torch, counters, smi: str, batch: int = 16) -> dict:
    """ChangeFormer's memory keys on the card: one f32 train step at b16,
    224^2, embed_dim 256, with (tail_chunks, remat_ffn) = (1, false), (8,
    false) and (8, true), from the same weights, batch and generator seed.
    Required: the running statistics bitwise equal, the loss within rtol
    1e-5 and the optimizer's moments within rel L2 1e-5 (the chunked tail
    sums its weight gradients chunk by chunk), the same launches, and the
    peak memory lower with the chunked tail. Returns the peaks (GiB)."""
    from kurosiwo_torch.device import configure_backends
    from kurosiwo_torch.models.factory import initialize_cd_model

    cfg = cd_config("changeformer", batch, mixed_precision=False)
    configure_backends(cfg, "cuda")
    data = cd_batch(torch, batch, IMAGE, seed=3)
    runs = {}
    for chunks, remat_ffn in ((1, False), (8, False), (8, True)):
        mc = {"optimizer": "adam", "learning_rate": 1e-3, "tail_chunks": chunks,
              "remat_ffn": remat_ffn}
        model = initialize_cd_model(cfg, mc, device="cpu", seed=7).to("cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = cd_step_on(torch, counters, model, cfg, mc, data, "cuda", [])
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        runs[chunks, remat_ffn] = r
        del model
        torch.cuda.empty_cache()
    params = {k for k, _ in initialize_cd_model(cfg, {}, device="cpu").named_parameters()}
    out = {}
    for (ka, kb), what in ((((1, False), (8, False)), "tail_chunks 8 vs 1"),
                           (((8, False), (8, True)), "remat_ffn true vs false")):
        a, b = runs[ka], runs[kb]
        l2 = ((a["moment"] - b["moment"]).norm() / a["moment"].norm()).item()
        stats_equal = all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"]
                          if k not in params)
        require(abs(a["loss"] - b["loss"]) <= 1e-5 * abs(a["loss"]),
                f"changeformer {what}: loss {b['loss']} vs {a['loss']}")
        require(l2 <= 1e-5 and stats_equal, f"changeformer {what}: moments rel L2 {l2}, "
                                            f"running statistics equal {stats_equal}")
        require(a["launched"] == b["launched"],
                f"changeformer {what}: launches {b['launched']} vs {a['launched']}")
        print(f"[cd-attn memory] ChangeFormer b{batch} f32 {what}: loss {b['loss']:.7f} vs "
              f"{a['loss']:.7f}, moments rel L2 {l2:.1e}, running statistics equal, launches "
              f"equal ({ {k: v for k, v in a['launched'].items() if v} }), peak "
              f"{b['peak_gib']:.2f} vs {a['peak_gib']:.2f} GiB [{smi}]", flush=True)
    require(runs[8, False]["peak_gib"] < runs[1, False]["peak_gib"],
            "changeformer: the chunked tail does not lower the peak memory")
    out = {f"tail_chunks={c},remat_ffn={str(r).lower()}": v["peak_gib"]
           for (c, r), v in runs.items()}
    return out


def attention_work_qk(b: int, nq: int, nk: int, h: int, d: int, elem: int) -> dict:
    """``attention_work`` for Nq != Nk: forward q, k, v in, out and lse out;
    backward q, k, v, do, out and lse in, dq, dk, dv out; the products
    QK^T and PV, and in the backward the recomputed QK^T, dV, dP, dQ, dK."""
    tq, tk = b * nq * h * d * elem, b * nk * h * d * elem
    stats = b * h * nq * 4
    prods = 2 * b * h * nq * nk * d
    return {"fwd": (2 * tq + 2 * tk + stats, 2 * prods), "bwd": (4 * tq + 4 * tk + stats,
                                                                 5 * prods)}


def phase_cd_attn_b4(torch, sa, shapes: dict, label: str = "cd-attn",
                     what: str = "b128 change-detection steps") -> dict:
    """B4 against its plain version at every short-attention shape the b128
    change-detection train steps launched (``shapes``: {(B, Nq, Nk, H*D,
    H): (leg, calls a step)}), forward and backward, f32 and bf16, q a
    tensor of its own and k, v the column halves of one kv tensor (as
    ChangeFormer's reduced keys come), with phase_short_attention's bands,
    two runs bitwise equal, and each call on the kernel its plan names; in
    bf16 the kernels' times beside the plain version's, SDPA's (a yardstick
    only) and the bound."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    fns = (sa.short_attention_fwd, sa.short_attention_bwd)
    out = {"shapes": len(shapes), "max_abs_err": {"fwd": 0.0, "bwd": 0.0}, "per_shape": {}}
    for (b, nq, nk, hd, h), (leg, calls) in sorted(shapes.items()):
        d = hd // h
        scale = d**-0.5
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            plan = sa.short_plan(dtype, d, nq, nk)
            q = torch.randn((b, nq, hd), device=dev, generator=g).to(dtype)
            k, v = torch.randn((b, nk, 2 * hd), device=dev, generator=g).to(dtype).chunk(2, -1)
            do = torch.randn((b, nq, hd), device=dev, generator=g).to(dtype)
            tag = f"short_attention {leg} {(b, nq, nk, hd)} H{h} {str(dtype)[6:]}"
            before = [dict(f.kernel_launches) for f in fns]
            o1, l1 = sa.short_attention_fwd(q, k, v, h, scale)
            o2, l2 = sa.short_attention_fwd(q, k, v, h, scale)
            wo, wl = sa.short_attention_fwd_plain(q, k, v, h, scale)
            oerr = (o1.float() - wo.float()).abs().max().item()
            lerr = (l1 - wl).abs().max().item()
            oband = (1e-5 if f32 else 1e-2) * wo.float().abs().max().item()
            lband = 1e-5 * wl.abs().max().item() if f32 else 1e-3
            require(oerr <= oband and lerr <= lband,
                    f"{tag}: out error {oerr:.3e} (band {oband:.3e}), lse {lerr:.3e} ({lband:.3e})")
            require(torch.equal(o1, o2) and torch.equal(l1, l2), f"{tag}: fwd not deterministic")
            delta = sa.attention_delta(do, wo, h)
            grads = sa.short_attention_bwd(q, k, v, do, wl, wo, h, scale)
            again = sa.short_attention_bwd(q, k, v, do, wl, wo, h, scale)
            want = sa.short_attention_bwd_plain(q, k, v, do, wl, delta, h, scale)
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
            out["max_abs_err"]["fwd"] = max(out["max_abs_err"]["fwd"], oerr)
            out["max_abs_err"]["bwd"] = max(out["max_abs_err"]["bwd"], gerr)
            print(f"[{label} b4] {tag} x{calls}/step: kernel {plan.kernel}, max abs error out "
                  f"{oerr:.3e}, lse {lerr:.3e}, grads {gerr:.3e}; deterministic", flush=True)
            del o1, o2, l1, l2, grads, again, want
            if f32:
                continue
            view = lambda t, n: t.reshape(b, n, h, d).transpose(1, 2)
            lq = view(q, nq).detach().requires_grad_(True)
            lk, lv = (view(t, nk).detach().requires_grad_(True) for t in (k, v))
            lib_out = F.scaled_dot_product_attention(lq, lk, lv, scale=scale)
            ldo = view(do, nq)
            ms_f = event_ms(torch, lambda: sa.short_attention_fwd(q, k, v, h, scale))
            ms_b = event_ms(torch, lambda: sa.short_attention_bwd(q, k, v, do, wl, wo, h, scale))
            pl_f = event_ms(torch, lambda: sa.short_attention_fwd_plain(q, k, v, h, scale), reps=3)
            pl_b = event_ms(torch, lambda: sa.short_attention_bwd_plain(q, k, v, do, wl, delta, h,
                                                                        scale), reps=3)
            lib_f = event_ms(torch, lambda: F.scaled_dot_product_attention(lq, lk, lv, scale=scale))
            lib_b = event_ms(torch, lambda: torch.autograd.grad(lib_out, (lq, lk, lv), ldo,
                                                                retain_graph=True))
            work = attention_work_qk(b, nq, nk, h, d, 2)
            row = {"leg": leg, "calls_per_step": calls, "kernel": plan.kernel}
            for kdir, ms, pl, lib in (("fwd", ms_f, pl_f, lib_f), ("bwd", ms_b, pl_b, lib_b)):
                bms, by = bound(*work[kdir], BF16_FLOP_PER_S)
                row[kdir] = {"ms": ms, "plain_ms": pl, "sdpa_ms": lib, "bound_ms": bms,
                             "bound_by": by}
                print(f"[{label} b4 {kdir}] {leg} {(b, nq, nk, hd)} H{h} bf16 x{calls}/step: "
                      f"{plan.kernel} kernel {ms:.4f} ms, plain {pl:.4f} ms, SDPA {lib:.4f} ms, "
                      f"bound {bms * 1e3:.1f} us ({by})", flush=True)
            out["per_shape"][f"{leg} ({b},{nq},{nk},{hd}) H{h}"] = row
            del lq, lk, lv, lib_out
        torch.cuda.empty_cache()
    print(f"[{label} b4] kernel vs plain at the {len(shapes)} short-attention shapes of the "
          f"{what}, f32 and bf16: max abs error fwd "
          f"{out['max_abs_err']['fwd']:.3e}, bwd {out['max_abs_err']['bwd']:.3e}", flush=True)
    return out


def cd_attn_eval(torch, counters, smi: str, model: str, warmup: int = 2,
                 steps: int = 5) -> dict:
    """The b128 f32-twin eval step of a bench leg (2 warm-up, 5 timed), or
    with ``eval_microbatch`` 32 when the whole batch does not fit: patches/s,
    peak memory; every launch a short-attention forward (f32: simt)."""
    from kurosiwo_torch import bench

    for micro in (0, BATCH // 4):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        b = None
        try:
            b = bench.setup(BATCH, overrides={"eval_microbatch": micro} if micro else {},
                            model=model)
            zero_counters(counters)
            seconds, eloss, metric = bench.run_eval(b, steps, warmup, f32=True)
        except torch.cuda.OutOfMemoryError:
            print(f"[cd-attn main] {model} eval b{BATCH} f32 twin"
                  f"{f', eval_microbatch {micro}' if micro else ''}: out of memory [{smi}]",
                  flush=True)
            del b
            continue
        n = warmup + steps
        launches = read_counters(counters)
        valid = int((b.batch["mask"] != 3).sum().item())
        require(bool(torch.isfinite(eloss).item()) and bank_counts_all(metric, n * valid)
                and launches["short_attention_fwd"] % n == 0
                and all(v == 0 for k, v in launches.items() if k != "short_attention_fwd"),
                f"{model} eval: loss {eloss.item()}, launches {launches}")
        res = {"eval_rate": steps * BATCH / seconds, "eval_ms": seconds / steps * 1e3,
               "eval_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "eval_microbatch": micro, "batch": BATCH,
               "short_attention_fwd": launches["short_attention_fwd"] // n}
        print(f"[cd-attn main] {model} eval b{BATCH} f32 twin"
              f"{f', eval_microbatch {micro}' if micro else ''}: {res['eval_rate']:.2f} "
              f"patches/s ({res['eval_ms']:.2f} ms/step), peak {res['eval_peak_gib']:.2f} GiB, "
              f"short_attention_fwd {res['short_attention_fwd']} a step [{smi}]", flush=True)
        del b
        torch.cuda.empty_cache()
        return res
    raise PhaseFailed(f"{model} f32-twin eval fits neither b{BATCH} nor its microbatches")


def cd_attn_leg(torch, counters, smi: str, tag: str, model: str, model_config: dict | None,
                bn_shapes: set, attn: dict, overrides: dict | None = None) -> dict:
    """A b128 bf16 train leg (2 warm-up, 5 timed, 2 profiled; 3, 10 and 3
    before the zoo phase joined the script) through ``cd_timed``, its
    short-attention shapes added to ``attn`` ({shape: (leg, calls a
    step)}); an out-of-memory leg prints a line and returns {"oom": True}."""
    import collections

    shapes = collections.Counter()
    try:
        res = cd_timed(torch, counters, smi, model, BATCH, overrides or {}, 2, 5,
                       bn_shapes=bn_shapes, model_config=model_config, attn_shapes=shapes,
                       tag=tag, profile_steps=2)
    except torch.cuda.OutOfMemoryError:
        print(f"[cd-attn main] {tag} b{BATCH}: out of memory [{smi}]", flush=True)
        torch.cuda.empty_cache()
        return {"oom": True}
    for shape, calls in shapes.items():
        attn.setdefault(shape, (tag, calls // 7))
    return res


def phase_cd_attn(torch, counters, smi: str, cli: list) -> dict:
    """The attention change-detection models: card against CPU (f32, one
    train and one eval step) for BiT-CD base_resnet18 and
    base_transformer_pos_s4_dd8, ChangeFormer with multi_scale_train and
    TransUNet-CD with siamese off and on; ChangeFormer's memory keys; the
    b128 bf16 train steps of BiT-CD (base_resnet18 and ..._dd8),
    ChangeFormer (its defaults, the f32-twin eval, and tail_chunks 1 with
    remat_ffn false) and TransUNet-CD, on the bench's config; B4 against its
    plain version at every short-attention shape those steps launched and
    B3 at every BatchNorm input shape; adds to ``cli`` the CLI once for
    BiT-CD and TransUNet-CD and twice for ChangeFormer. Returns the numbers
    of each."""
    from kurosiwo_torch.ops import short_attention as sa

    t0 = time.perf_counter()
    out = {"parity": {}}
    for tag, method, mc, bsz, side in CD_ATTN_SMALL:
        mc = dict(mc, optimizer="adam", learning_rate=1e-3)
        out["parity"][tag] = cd_card_vs_cpu(torch, counters, tag, method, mc, bsz, side)
    torch.cuda.empty_cache()
    marks = {"parity": time.perf_counter() - t0}
    out["memory_keys"] = phase_cd_attn_memory(torch, counters, smi)
    marks["memory keys"] = time.perf_counter() - t0 - sum(marks.values())
    bn_shapes: set = set()
    attn: dict = {}
    leg = lambda *a, **kw: cd_attn_leg(torch, counters, smi, *a, bn_shapes=bn_shapes,
                                       attn=attn, **kw)
    out["bit-cd"] = leg("bit-cd base_resnet18", "bit-cd", None)
    out["bit-cd dd8"] = leg("bit-cd base_transformer_pos_s4_dd8", "bit-cd", BIT_DD8)
    out["changeformer"] = leg("changeformer", "changeformer", None)
    out["changeformer eval"] = cd_attn_eval(torch, counters, smi, "changeformer")
    out["changeformer no memory keys"] = leg("changeformer tail_chunks 1, remat_ffn false",
                                             "changeformer",
                                             {"tail_chunks": 1, "remat_ffn": False})
    out["transunet-cd"] = leg("transunet-cd", "transunet-cd", None)
    for name in ("bit-cd", "bit-cd dd8", "changeformer", "transunet-cd"):
        require(not out[name].get("oom"), f"{name} b{BATCH} ran out of memory")
    # 41 BatchNorms forward and backward; at resnet_stages_num 4 the 10 of
    # layer4 (which runs and feeds nothing) have no backward; ChangeFormer's
    # 9 less the 4 of the prediction heads off the loss (no multi_scale_train)
    # on the way back; TransUNet-CD's 36 each way
    want = {"bit-cd": 82, "bit-cd dd8": 72, "changeformer": 14, "transunet-cd": 72}
    got = {k: out[k]["pair_sums"] for k in want}
    require(got == want, f"pair_sums a step {got}, expected {want}")
    sa_steps = {k: out[k].get("short_attention", {}) for k in ("bit-cd dd8", "changeformer")}
    require(sa_steps["bit-cd dd8"] == {"short_attention_fwd.wgmma": 1,
                                       "short_attention_fwd.mma_sync": 16,
                                       "short_attention_bwd.wgmma": 1,
                                       "short_attention_bwd.mma_sync": 16}
            and sa_steps["changeformer"] == {"short_attention_fwd.wgmma": 6,
                                             "short_attention_fwd.mma_sync": 6,
                                             "short_attention_bwd.wgmma": 6,
                                             "short_attention_bwd.mma_sync": 6},
            f"short-attention launches a step by kernel {sa_steps}")
    require(not out["bit-cd"].get("short_attention") and not out["transunet-cd"].get(
        "short_attention"), "a leg without B4 launched it")
    marks["legs"] = time.perf_counter() - t0 - sum(marks.values())
    out["b4"] = phase_cd_attn_b4(torch, sa, attn)
    out["pair_sums_check"] = phase_cd_pair_sums(torch, bn_shapes)
    marks["kernels"] = time.perf_counter() - t0 - sum(marks.values())

    cfg, inputs = {"on_screen_prints": True, "task": "cd"}, ("--inputs", "pre_event_1",
                                                             "post_event")
    flags = " ".join(inputs) + " "

    def check(results: list) -> None:
        for method, res in zip(("bit-cd", "transunet-cd"), results):
            run = cli_finish(res)
            require(any(f.endswith("checkpoint_epoch=0.ptr.json") for f in run["files"]),
                    f"the {method} CLI left no checkpoint_epoch=0: {run['files']}")
            first = next(x for x in run["lines"] if x.get("Iteration") == 0)["Train Loss"]
            print(f"[cd-attn cli] python -m kurosiwo_torch --method {method} {flags}--seed 7 "
                  f"(\"task\": \"cd\"): exit 0 in {run['seconds']:.1f} s ({run['at_once']} at "
                  f"once at most), first-step loss {first}, Test Mean IOU {run['miou']!r}, "
                  f"checkpoint_epoch=0 written [{smi}]", flush=True)
        cli_pair_check("cd-attn", "changeformer", flags, smi, results[2:],
                       note=' ("task": "cd")')

    cli.append(CliJob([(cfg, (m,), inputs) for m in ("bit-cd", "transunet-cd", "changeformer",
                                                      "changeformer")], check))
    out["wall_s"] = time.perf_counter() - t0
    print(f"[cd-attn] phase wall {out['wall_s']:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in marks.items())}; its CLI runs in the CLI "
          f"pool) [{smi}]", flush=True)
    return out


# the rest of the segmentation zoo at a small size, card against CPU: (tag,
# method, model config, config keys, batch, side). DeepLabV3+ at batch 4 (its
# global-pool BatchNorm normalizes B values a channel); UperNet through the
# tests' backbone_spec (Swin at 56^2: windows of 7, 7, 4, 2); the finetuner's
# ViT with 2 heads of 64 over 17 tokens (B4's simt kernels in f32).
ZOO_VIT = {"image_size": 64, "dim": 128, "depth": 2, "heads": 2, "mlp_dim": 256}
ZOO_SMALL = (
    ("unet++ resnet18", "unet++", {"backbone": "resnet18"}, {}, 2, 64),
    ("deeplabv3 resnet18", "deeplabv3", {"backbone": "resnet18"}, {}, 4, 64),
    ("deeplabv3 resnet50", "deeplabv3", {"backbone": "resnet50"}, {}, 4, 64),
    ("upernet convnext", "upernet", {"backbone": "convnext_tiny",
                                     "backbone_spec": [[1, 1, 2, 1], [32, 64, 96, 128]]}, {}, 2,
     64),
    ("upernet swin", "upernet", {"backbone": "swin_tiny",
                                 "backbone_spec": [[2, 2, 2, 2], 32, [1, 2, 2, 4]]}, {}, 2, 56),
    ("finetune mlp", "finetune", {}, dict(ZOO_VIT, mlp=True), 2, 64),
    ("finetune decoder", "finetune", {}, dict(ZOO_VIT, mlp=False, decoder=True), 2, 64),
    ("finetune linear", "finetune", {}, dict(ZOO_VIT, mlp=False, decoder=False), 2, 64),
)
# the full-width legs on the bench's config: (tag, bench model, model config,
# the batches to try). The finetuner's b128 step does not fit an 80 GB card
# (its f32 224^2 x 1024 resize alone is 26 GB; measured out of memory in
# an NVIDIA H100 80GB HBM3 at 700 W; PERF.md), so its search starts at b64,
# as HFA-Net's does
ZOO_LEGS = (
    ("unet++ resnet18", "unet++", None, (BATCH,)),
    ("deeplabv3 resnet18", "deeplabv3", None, (BATCH,)),
    ("upernet convnext_tiny", "upernet", None, (BATCH,)),
    ("finetune ViT-L", "finetune", None, (BATCH // 2, BATCH // 4)),
    ("upernet swin_tiny", "upernet", {"backbone": "swin_tiny"}, (BATCH,)),
    ("deeplabv3 resnet50", "deeplabv3", {"backbone": "resnet50"}, (BATCH,)),
)
ZOO_CLI = ("unet++", "deeplabv3", "upernet", "finetune")
# the zoo and recurrent legs' train and f32-eval steps: warm-up, timed (3
# and 10 before the MAE-loop and recurrent phases joined the script, 2 and 5
# before the diffusion phase, within its time limit)
ZOO_STEPS = (2, 3)


def zoo_swin_deterministic(torch) -> None:
    """The relative-position table's gradient (an ``index_select``, whose
    backward accumulates by index) on the card with deterministic
    algorithms on: two backward passes of a small Swin UperNet, bitwise
    equal."""
    from kurosiwo_torch.device import configure_backends
    from kurosiwo_torch.models.upernet import UperNet

    configure_backends({"deterministic": True}, "cuda")
    model = UperNet(6, 3, "swin_tiny", channels=32, backbone_spec=ZOO_SMALL[4][2]["backbone_spec"],
                    image_size=56, generator=torch.Generator().manual_seed(0)).cuda()
    x = torch.randn(2, 56, 56, 6, generator=torch.Generator().manual_seed(1)).cuda()
    grads = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        model(x, torch.bfloat16).float().square().mean().backward()
        grads.append([p.grad.clone() for n, p in model.named_parameters()
                      if n.endswith("relative_position_bias")])
    require(len(grads[0]) == 8 and all(torch.equal(a, b) for a, b in zip(*grads)),
            "Swin's relative-position gradients differ between two deterministic backwards")
    print(f"[seg-zoo swin] relative-position table gradients of {len(grads[0])} blocks: two "
          "bf16 backward passes on the card bitwise equal (deterministic algorithms)", flush=True)


def zoo_leg(torch, counters, smi: str, tag: str, model: str, model_config: dict | None,
            bn_shapes: set, attn: dict, batches: tuple = (BATCH, BATCH // 2, BATCH // 4),
            label: str = "seg-zoo main") -> dict:
    """A full-width bf16 train leg (ZOO_STEPS: 2 warm-up, 3 timed; 2
    profiled) and its f32-twin eval (ZOO_STEPS) through
    ``cd_timed`` at the first of ``batches`` that fits (named on its line);
    its short-attention shapes go to ``attn``."""
    import collections
    import gc

    for batch in batches:
        shapes = collections.Counter()
        try:
            res = cd_timed(torch, counters, smi, model, batch, {}, *ZOO_STEPS, eval_too=True,
                           eval_steps=ZOO_STEPS, profile_steps=2, bn_shapes=bn_shapes,
                           model_config=model_config,
                           attn_shapes=shapes, tag=tag, label=label)
        except torch.cuda.OutOfMemoryError:
            print(f"[{label}] {tag} b{batch}: out of memory [{smi}]", flush=True)
            res = None
        if res is not None:
            for shape, calls in shapes.items():
                attn.setdefault(shape, (tag, calls // sum(ZOO_STEPS)))
            return res
        gc.collect()
        torch.cuda.empty_cache()
    raise PhaseFailed(f"{tag}: no batch of {batches} fits")


def phase_seg_zoo(torch, counters, smi: str, cli: list) -> dict:
    """The rest of the segmentation zoo (UNet++, DeepLabV3+ on resnet18 and
    resnet50, UperNet on ConvNeXt and Swin, the FloodViT finetuner): card
    against CPU (f32, one train and one eval step) for each model and head at
    a small size; Swin's relative-position gradients deterministic on the
    card; the b128 bf16 train steps and f32-twin evals of the six shipped
    legs on the bench's config, each BatchNorm model launching B3 twice a
    BatchNorm a step and the finetuner B4 24 times each way on the wgmma
    kernels; B3 against its plain version at every BatchNorm input shape of
    those steps and B4 at the finetuner's shapes; adds to ``cli`` the CLI
    twice at one seed for unet++, deeplabv3, upernet and finetune (at the
    batch its leg fit). Returns the numbers of each."""
    from kurosiwo_torch.ops import short_attention as sa

    t0 = time.perf_counter()
    out = {"parity": {}}
    for tag, method, mc, keys, bsz, side in ZOO_SMALL:
        mc = dict(mc, optimizer="adam", learning_rate=1e-3)
        launched = cd_card_vs_cpu(torch, counters, tag, method, mc, bsz, side,
                                  task="segmentation", keys=keys)
        require(launched["pair_sums"] > 0 if method != "finetune"
                else launched["short_attention_fwd"] == launched["short_attention_bwd"] == 2,
                f"{tag}: card step launched {launched}")
        out["parity"][tag] = {k: v for k, v in launched.items() if v}
    torch.cuda.empty_cache()
    zoo_swin_deterministic(torch)
    marks = {"parity": time.perf_counter() - t0}
    bn_shapes: set = set()
    attn: dict = {}
    for tag, model, mc, batches in ZOO_LEGS:
        res = zoo_leg(torch, counters, smi, tag, model, mc, bn_shapes, attn, batches)
        want = 2 * res["batchnorms"]
        require(res["pair_sums"] == want and (want > 0) == (model != "finetune"), f"{tag}: pair_sums a step {res['pair_sums']}, "
                                          f"expected {want} (each BatchNorm, both ways)")
        sa_step = res.get("short_attention", {})
        require(sa_step == ({"short_attention_fwd.wgmma": 24, "short_attention_bwd.wgmma": 24}
                            if model == "finetune" else {}),
                f"{tag}: short-attention launches a step {sa_step}")
        out[tag] = res
        torch.cuda.empty_cache()
    marks["legs"] = time.perf_counter() - t0 - sum(marks.values())
    out["b4"] = phase_cd_attn_b4(torch, sa, attn, label="seg-zoo", what="finetuner's step")
    out["pair_sums_check"] = phase_cd_pair_sums(torch, bn_shapes, label="seg-zoo",
                                                what="zoo's b128 train steps")
    marks["kernels"] = time.perf_counter() - t0 - sum(marks.values())
    # the CLI twice a method at one seed, the finetuner's at the batch its leg
    # fit (b128 does not fit an 80 GB card; b64 peaks at 35 GiB)
    fit = out["finetune ViT-L"]["batch"]
    extra = {m: ("--batch_size", str(fit)) if m == "finetune" and fit != BATCH else ()
             for m in ZOO_CLI}
    cfg = {"on_screen_prints": True}
    out["cli"] = {}

    def check(results: list) -> None:
        for i, method in enumerate(ZOO_CLI):
            flags = "".join(f"{x} " for x in extra[method])
            a, _ = cli_pair_check("seg-zoo", method, flags, smi, results[2 * i:2 * i + 2],
                                  epoch_checkpoint=False)
            out["cli"][method] = a["miou"]

    cli.append(CliJob([(cfg, (m,), extra[m]) for m in ZOO_CLI for _ in range(2)], check))
    out["wall_s"] = time.perf_counter() - t0
    print(f"[seg-zoo] phase wall {out['wall_s']:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in marks.items())}; its CLI runs in the CLI "
          f"pool) [{smi}]", flush=True)
    return out


def zoo_summary(zoo: dict, smi: str) -> str:
    """One line of the seg-zoo phase's numbers, printed near the end."""
    return "[seg-zoo summary] " + json.dumps({
        "card": smi, "legs": _legs(zoo), "b4_finetune": zoo["b4"],
        "pair_sums_zoo_shapes": zoo["pair_sums_check"], "card_vs_cpu_launches": zoo["parity"],
        "cli_test_miou": zoo["cli"], "phase_wall_s": zoo["wall_s"]})


# the MAE loop at a small size, card against CPU: MAE_SMALL's ViT at accum 2,
# 2 epochs of 4 steps of b8, lr_scales on (first pattern wins)
MAE_LOOP_SMALL = dict(MAE_SMALL, accumulate_gradients=2, warmup_epochs=1, learning_rate=1e-4,
                      min_lr=0)
MAE_LOOP_SCALES = {"transformer/attn_0/": 0.5, "encoder/": 0.25, "decoder/": 2.0}
# the full-width loop: the shipped mae.json at b128 (train_config.json), 2
# epochs of this many steps on the synthetic SSL source; epoch 0 is the
# warm-up, epoch 1 the timed run
MAE_LOOP_STEPS = 4


def mae_loop_config(root, **kw) -> dict:
    """The MAE task's config as the CLI builds it (``load_config`` on the
    repository's configs with ``"task": "mae"``), run under ``root``."""
    from pathlib import Path

    from kurosiwo_torch.config import load_config

    cfg = load_config(method="mae", config_root=Path(__file__).resolve().parent / "configs")
    cfg.update(task="mae", root_path=str(Path(root) / "no-corpus"),
               checkpoint_path=str(Path(root) / "mae"), **kw)
    return cfg


@contextlib.contextmanager
def timed_mae_loop():
    """While active, the MAE loop's loader and checkpoint manager record, for
    each epoch of ring batches, its start, the host time spent waiting for
    batches and the host time between them (the step's), and for each save
    its start, seconds and bytes. Yields {"epochs": [...], "saves": [...]}."""
    from kurosiwo_torch.training import mae as tmae

    rec: dict = {"epochs": [], "saves": []}
    loader_cls, ckpt_cls = tmae.SSLLoader, tmae.CheckpointManager

    class TimedLoader(loader_cls):
        def ring_batches(self, pin: bool = False):
            ep = {"start": time.perf_counter(), "wait": 0.0, "host": 0.0, "batches": 0}
            rec["epochs"].append(ep)
            t = time.perf_counter()
            for batch in super().ring_batches(pin):
                got = time.perf_counter()
                ep["wait"] += got - t
                ep["batches"] += 1
                yield batch
                t = time.perf_counter()
                ep["host"] += t - got

    class TimedCheckpoints(ckpt_cls):
        def save(self, name, state, extra=None):
            t = time.perf_counter()
            super().save(name, state, extra)
            nbytes = (self.dir / self._read_ptr(name)["slot"]).stat().st_size
            rec["saves"].append({"name": name, "start": t, "s": time.perf_counter() - t,
                                 "bytes": nbytes})

    tmae.SSLLoader, tmae.CheckpointManager = TimedLoader, TimedCheckpoints
    try:
        yield rec
    finally:
        tmae.SSLLoader, tmae.CheckpointManager = loader_cls, ckpt_cls


def mae_loop_on(torch, counters, root, device: str, noise: list):
    """``training/mae.train`` at MAE_LOOP_SMALL on ``device``: the card draws
    each microbatch's masking noise as its step would and records it into
    ``noise``, the CPU replays it. Returns the losses, the learning rates,
    the final parameters, the card's launches and the CPU's plain B4
    calls."""
    from kurosiwo_torch.ops import short_attention as sa
    from kurosiwo_torch.training import mae as tmae

    real_step, real_sched = tmae.make_mae_train_step, tmae.mae_warmup_cosine
    plains = {"short_attention_fwd": "short_attention_fwd_plain",
              "short_attention_bwd": "short_attention_bwd_plain"}
    real_plain = {k: getattr(sa, name) for k, name in plains.items()}
    plain, lrs = dict.fromkeys(plains, 0), []

    def make_step(model, accum, device):
        step = real_step(model, accum, device=device)
        n = model.encoder.num_patches

        def one(state, batch, lr, gen):
            micro = batch["image"].shape[0] // accum
            if device.type == "cuda":
                z = torch.stack([torch.rand((micro, n), generator=gen, device=device)
                                 for _ in range(accum)])
                noise.append(z.cpu())
            else:
                z = noise.pop(0)
            return step(state, batch, lr, gen, noise=z)
        return one

    def sched(*a):
        schedule = real_sched(*a)
        return lambda e: lrs.append(schedule(e)) or lrs[-1]

    def counting(key):
        def call(*a):
            plain[key] += 1
            return real_plain[key](*a)
        return call

    tmae.make_mae_train_step, tmae.mae_warmup_cosine = make_step, sched
    for k, name in plains.items():
        setattr(sa, name, counting(k))
    try:
        cfg = mae_loop_config(root / device, mixed_precision=False, batch_size=8,
                              synthetic_size=32, synthetic_patch_size=112, num_workers=4,
                              epochs=2, print_frequency=10**6, lr_scales=MAE_LOOP_SCALES)
        losses: list = []
        zero_counters(counters)
        state = tmae.train(cfg, seed=5, model_configs=MAE_LOOP_SMALL, record_losses=losses,
                           device=device)
        launched = read_counters(counters)
    finally:
        tmae.make_mae_train_step, tmae.mae_warmup_cosine = real_step, real_sched
        for k, name in plains.items():
            setattr(sa, name, real_plain[k])
    return {"losses": losses, "lrs": lrs, "launched": launched, "plain": plain,
            "groups": [g["lr_scale"] for g in state.optimizer.param_groups],
            "params": {k: v.detach().cpu() for k, v in state.model.named_parameters()}}


def mae_loop_card_vs_cpu(torch, counters) -> dict:
    """The MAE loop (``training/mae.train``: the SSL loader, the schedule, the
    bf16-moment Adam with ``lr_scales``, the checkpoints) at MAE_LOOP_SMALL,
    f32, 2 epochs of 4 steps, on the card against the CPU, the card's
    masking noise replayed on the CPU: the same learning rates and groups;
    the first step's loss rtol 1e-4 (the same weights), the others 5e-3;
    parameters all within twice the summed largest scaled lr and 99% within
    0.3 of it (Adam's sign flips, C6); B4 launched once for each plain call
    of the CPU run."""
    import tempfile
    from pathlib import Path

    noise: list = []
    with tempfile.TemporaryDirectory() as tmp:
        g = mae_loop_on(torch, counters, Path(tmp), "cuda", noise)
        drawn = len(noise)
        c = mae_loop_on(torch, counters, Path(tmp), "cpu", noise)
    require(not noise and drawn == len(c["losses"]) == 8,
            f"MAE loop: {drawn} noise draws for {len(c['losses'])} CPU steps")
    require(g["lrs"] == c["lrs"] and g["groups"] == c["groups"] == [1.0, 0.25, 0.5, 2.0],
            f"MAE loop lrs {g['lrs']} / {c['lrs']}, groups {g['groups']} / {c['groups']}")
    gl, cl = g["losses"], c["losses"]
    require(abs(gl[0] - cl[0]) <= 1e-4 * abs(cl[0]) and all(
        abs(a - b) <= 5e-3 * abs(b) for a, b in zip(gl, cl)), f"MAE loop losses {gl} vs {cl}")
    total = 2.0 * sum(c["lrs"])  # the largest scale
    d = torch.cat([(g["params"][k] - c["params"][k]).abs().reshape(-1) for k in c["params"]])
    pmax, share = d.max().item(), (d <= 0.3 * total).float().mean().item()
    require(pmax <= 2 * total + 1e-7 and share >= 0.99,
            f"MAE loop params: max {pmax}, share within 0.3 x summed lr {share}")
    want = {k: 0 for k in counters} | c["plain"]
    require(g["launched"] == want and c["plain"]["short_attention_fwd"] > 0,
            f"MAE loop card launches {g['launched']}, the CPU's plain calls {c['plain']}")
    print(f"[mae-train parity] loop f32 2 epochs x 4 steps b8 accum 2 (lr_scales groups "
          f"{g['groups']}) card vs CPU: losses {[round(x, 6) for x in gl]} vs "
          f"{[round(x, 6) for x in cl]}, params max {pmax:.2e} ({share * 100:.2f}% within 0.3 "
          f"x summed lr), B4 launches {g['launched']['short_attention_fwd']} / "
          f"{g['launched']['short_attention_bwd']} for {c['plain']} plain calls", flush=True)
    return {k: v for k, v in g["launched"].items() if v}


def mae_loop_main(torch, counters, smi: str, attn) -> dict:
    """The full-width MAE loop: the shipped mae.json (ViT-L 1024 x 24, 16
    heads of 64, decoder 512 x 8, accum 4) at b128 on the synthetic SSL
    source, 2 epochs of MAE_LOOP_STEPS steps through ``training/mae.train``
    (bf16, Adam with bf16 moments), epoch 1 timed: patches/s, the host time
    a step outside the loader wait, B4 launches a step by kernel (every one
    on the wgmma kernels), the peak memory and the seconds and bytes of the
    mae_0 and vit_0 saves; then the SSL loader alone over one epoch (after
    its start-up), and the card's busy time a step (torch.profiler, 2 steps
    of the trained state) and so its idle share of the timed epoch. Its
    short-attention calls are counted in ``attn``."""
    import tempfile

    from kurosiwo_torch import bench
    from kurosiwo_torch.data.ssl import SSLLoader
    from kurosiwo_torch.training import mae as tmae

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = mae_loop_config(tmp, synthetic_size=MAE_LOOP_STEPS * BATCH, epochs=2,
                              print_frequency=MAE_LOOP_STEPS)
        mcfg = cfg["model_config"]
        accum = int(mcfg["accumulate_gradients"])
        require(cfg["batch_size"] == BATCH and accum == 4 and mcfg["dim"] == 1024,
                f"the shipped MAE config: batch {cfg['batch_size']}, accum {accum}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counters(counters)
        with timed_mae_loop() as rec, recording_attention_shapes(attn):
            state = tmae.train(cfg, seed=7, model_configs=mcfg)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches, by_kernel = read_counters(counters), read_kernel_counters(counters)
        steps = 2 * MAE_LOOP_STEPS
        ep = rec["epochs"][1]
        saves = {x["name"]: x for x in rec["saves"]}
        require(sorted(saves) == ["mae_0", "mae_1", "vit_0", "vit_1"] and state.step == steps
                and ep["batches"] == MAE_LOOP_STEPS, f"MAE loop: saves {sorted(saves)}, "
                f"{state.step} steps, {ep['batches']} batches in epoch 1")
        seconds = saves["mae_1"]["start"] - ep["start"]
        per_step = 32 * accum  # 24 encoder + 8 decoder layers a microbatch
        want = {k: 0 for k in counters} | {"short_attention_fwd": per_step * steps,
                                           "short_attention_bwd": per_step * steps}
        wgmma = {k: v for k, v in by_kernel.items() if k.startswith(ATTN_WRAPPERS) and v}
        require(launches == want and wgmma == {
            "short_attention_fwd.wgmma": per_step * steps,
            "short_attention_bwd.wgmma": per_step * steps},
            f"MAE loop launches {launches}, by kernel {wgmma}")
        out = {"batch": BATCH, "accum": accum, "steps": MAE_LOOP_STEPS,
               "rate": MAE_LOOP_STEPS * BATCH / seconds, "ms": seconds / MAE_LOOP_STEPS * 1e3,
               "wait_s": ep["wait"], "host_ms": ep["host"] / MAE_LOOP_STEPS * 1e3,
               "peak_gib": peak, "short_attention": {k: v // steps for k, v in wgmma.items()},
               "saves": {k: {"s": v["s"], "bytes": v["bytes"]} for k, v in saves.items()}}
        # the card's busy time a step: 2 profiled steps of the trained state
        images = torch.randn((BATCH, 224, 224, 6), device=dev,
                             generator=torch.Generator(dev).manual_seed(3))
        step = tmae.make_mae_train_step(state.model, accum, device=dev)
        gen = torch.Generator(dev).manual_seed(4)
        prof = bench.profile(lambda: step(state, {"image": images}, 1e-6, gen)[1], 2, dev,
                             out["ms"], file=sys.stdout)
        out["busy_ms"] = prof["kernel_ms"]
        out["idle"] = max(0.0, 1 - out["busy_ms"] / out["ms"])
        del state, step, images
        torch.cuda.empty_cache()
        # the SSL loader alone: one epoch of ring batches after its start-up
        loader = SSLLoader(cfg, seed=7)
        try:
            loader._start()
            n, t0 = 0, time.perf_counter()
            for b in loader.ring_batches():
                n += len(b["image"])
                b.release()
            out["loader_alone"] = n / (time.perf_counter() - t0)
        finally:
            loader.close()
    print(f"[mae-train main] loop ViT-L b{BATCH} accum {accum} bf16 (the shipped mae.json, "
          f"synthetic SSL source, {cfg['num_workers']} decode processes): epoch 1 "
          f"{out['rate']:.2f} patches/s ({out['ms']:.2f} ms/step, {ep['wait']:.3f} s waiting on "
          f"the loader, host {out['host_ms']:.2f} ms a step outside the wait), the SSL loader "
          f"alone {out['loader_alone']:.2f} patches/s, device busy {out['busy_ms']:.2f} ms/step "
          f"(idle {out['idle'] * 100:.1f}% of the timed epoch), peak {peak:.2f} GiB, B4 a step "
          f"{out['short_attention']}; saves "
          + ", ".join(f"{k} {v['s']:.2f} s {v['bytes']} B" for k, v in sorted(out["saves"].items()))
          + f" [{smi}]", flush=True)
    return out


def mae_cli_finish(res: dict, smi: str) -> dict:
    """Of the CLI run ``python -m kurosiwo_torch --method mae --seed 7`` with
    ``"task": "mae"`` in a copy of the shipped configs (ViT-L at b128, accum
    4, the 256-sample synthetic SSL source: 2 steps; a ``cli_collect``
    result): exit 0, finite printed losses, mae_0 and vit_0 written."""
    import re

    written = sorted(f.rsplit("/", 1)[-1] for f in res["files"] if f.endswith(".ptr.json"))
    losses = [float(x) for x in re.findall(r"loss=(\S+) lr=", res["stdout"])]
    if res["rc"] or not losses:
        print(res["stdout"][-3000:], res["stderr"][-3000:], sep="\n", flush=True)
    require(res["rc"] == 0, f"the MAE CLI exited {res['rc']}")
    require(losses and all(math.isfinite(x) for x in losses), f"the MAE CLI's losses {losses}")
    require({"mae_0.ptr.json", "vit_0.ptr.json"} <= set(written),
            f"the MAE CLI wrote {written}")
    print(f"[mae-train cli] python -m kurosiwo_torch --method mae --seed 7 (\"task\": \"mae\", "
          f"shipped mae.json at b{BATCH}): exit 0 in {res['seconds']:.1f} s ({res['at_once']} at "
          f"once at most), losses {losses}, wrote {written} [{smi}]", flush=True)
    return {"seconds": res["seconds"], "losses": losses}


def phase_mae_train(torch, counters, smi: str, sa, cli: list) -> dict:
    """MAE pretraining end to end: the loop card against CPU at a small size,
    the full-width loop, B4 against its plain version at the loop's
    microbatch shapes (its time beside SDPA's and its bound); adds to
    ``cli`` the CLI with ``"task": "mae"``. Returns the numbers of each."""
    import collections

    t0 = time.perf_counter()
    out = {"parity": mae_loop_card_vs_cpu(torch, counters)}
    marks = {"parity": time.perf_counter() - t0}
    shapes = collections.Counter()
    out["main"] = mae_loop_main(torch, counters, smi, shapes)
    calls = 2 * MAE_LOOP_STEPS
    out["b4"] = phase_cd_attn_b4(torch, sa, {k: ("mae loop", v // calls)
                                             for k, v in shapes.items()},
                                 label="mae-train", what="MAE loop's microbatches")
    marks["main"] = time.perf_counter() - t0 - sum(marks.values())
    torch.cuda.empty_cache()
    cli.append(CliJob([({"task": "mae"}, ("mae",), ())],
                      lambda results: out.update(cli=mae_cli_finish(results[0], smi))))
    out["wall_s"] = time.perf_counter() - t0
    print(f"[mae-train] phase wall {out['wall_s']:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in marks.items())}; its CLI run in the CLI "
          f"pool) [{smi}]", flush=True)
    return out


# the recurrent task: card against CPU at (2, 3, 64, 64, 2), f32
RECURRENT_SMALL = (2, 64)


def phase_recurrent(torch, counters, smi: str, fused_tail, cli: list) -> dict:
    """The recurrent task (the ConvLSTM): one f32 train and eval step card
    against CPU at a small size (``cd_card_vs_cpu``); the b128 bf16 train
    step on the bench's config (three 224^2 frames of 2 channels; b64 or
    b32 where b128 does not fit) and its f32-twin eval; one step with
    ``fused_tail: true``, B2 launched once each way, its loss and banks
    against the plain tail's; B2 against its plain version at the step's
    (B, 224, 224, 3) f32 probabilities, timed beside the plain version, the
    library yardstick and the bound; adds to ``cli`` the CLI twice at one
    seed (``--method convlstm``, the shipped configs), which must write
    ``checkpoint_epoch=0`` and print the same numbers. Returns the numbers of
    each."""
    from kurosiwo_torch import bench

    t0 = time.perf_counter()
    bsz, side = RECURRENT_SMALL
    mc = dict(bench.MODEL_CONFIG, optimizer="adam", learning_rate=1e-3)
    out = {"parity": {k: v for k, v in cd_card_vs_cpu(
        torch, counters, "convlstm", "convlstm", mc, bsz, side, task="recurrent").items() if v}}
    marks = {"parity": time.perf_counter() - t0}
    out["convlstm"] = res = zoo_leg(torch, counters, smi, "convlstm", "convlstm", None, set(),
                                    {}, label="recurrent main")
    require(res["pair_sums"] == 0 and "short_attention" not in res,
            f"the ConvLSTM step launched pair_sums {res['pair_sums']}")
    batch = res["batch"]
    marks["legs"] = time.perf_counter() - t0 - sum(marks.values())

    # the fused CE + confusion-matrix tail (B2) on the recurrent step, against the plain tail
    from kurosiwo_torch.training.steps import assemble_recurrent_input

    out["fused_tail"], b = fused_tail_step(torch, counters, "convlstm", batch, {}, "recurrent")
    with torch.no_grad():  # the trained step's probabilities, B2's input
        probs = b.state.model(assemble_recurrent_input(b.batch, b.config)).contiguous()
    labels = b.batch["mask"].to(torch.int32)
    del b
    torch.cuda.empty_cache()
    cw = torch.tensor(CW, device="cuda")
    tag = f"nhwc ConvLSTM probabilities {tuple(probs.shape)} f32"
    lerr, derr, unit = ce_cm_check(torch, fused_tail, "nhwc", probs, labels, cw, tag)
    times = ce_cm_times(torch, fused_tail, "nhwc", probs, labels, cw)
    out["b2"] = {"shape": list(probs.shape), "unit": unit, "fwd": dict(times["fwd"],
                 max_abs_err=lerr), "bwd": dict(times["bwd"], max_abs_err=derr)}
    for k in ("fwd", "bwd"):
        o = out["b2"][k]
        print(f"[recurrent b2 {k}] {tag}: {unit} unit, kernel {o['ms']:.4f} ms, plain "
              f"{o['plain_ms']:.4f} ms, library {o['library_ms']:.4f} ms, bound "
              f"{o['bound_ms'] * 1e3:.1f} us ({o['bound_by']}), max abs error "
              f"{o['max_abs_err']:.3e}", flush=True)
    del probs, labels
    torch.cuda.empty_cache()
    marks["b2"] = time.perf_counter() - t0 - sum(marks.values())

    # the CLI twice at one seed on the shipped configs, at the batch the leg fit
    extra = ("--batch_size", str(batch)) if batch != BATCH else ()

    def check(results: list) -> None:
        flags = "".join(f"{x} " for x in extra)
        out["cli"] = cli_pair_check("recurrent", "convlstm", flags, smi, results)[0]["miou"]

    cli.append(CliJob([({"on_screen_prints": True}, ("convlstm",), extra)] * 2, check))
    out["wall_s"] = time.perf_counter() - t0
    print(f"[recurrent] phase wall {out['wall_s']:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in marks.items())}; its CLI pair runs in the "
          f"CLI pool) [{smi}]", flush=True)
    return out


# the diffusion task (A10) and the raster CLI (A11): the DDPM card against
# CPU at dim 16, dim_mults (1, 2), 32^2, batch 4, f32 (lr 1e-3, so that
# adam_step_close's 3e-4 is 0.3 lr); the full-width leg on the shipped
# diffusion.json (bench.setup_diffusion) at the first of these batches that
# fits; the raster CLI on a scene of this side
DIFF_SMALL = {"dim": 16, "dim_mults": [1, 2], "timesteps": 10, "learning_rate": 1e-3}
DIFF_STEPS = (2, 5)
DIFF_BATCHES = (BATCH, BATCH // 2, BATCH // 4)
RASTER_SIDE = 2048


@contextlib.contextmanager
def backend_flags(torch):
    """The backend flags that ``configure_backends`` sets, restored after the
    block (a block that sets the segmentation task's deterministic
    algorithms leaves the later phases as they were)."""
    saved = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled())
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved[:2]
        torch.use_deterministic_algorithms(saved[2])


def diffusion_card_vs_cpu(torch, counters) -> dict:
    """A 10-step ``sample`` chain (timesteps 10) from the same draws, then one
    f32 train step (the loss, every gradient, Adam's update) from the same
    weights, timesteps and noise, of the DDPM at DIFF_SMALL on (4, 32, 32,
    2), on the card against the CPU. Bands: the loss within 1e-5 of it; each
    gradient within 1e-3 of its tensor's largest value plus 1e-5 of the
    tree's (a conv bias before a GroupNorm has a gradient of rounding noise,
    zero in exact arithmetic); the parameters as ``adam_step_close`` (C6);
    the chain within 1e-4 of its largest value. No kernel is launched."""
    import numpy as np

    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.training.diffusion import make_diffusion_train_step
    from kurosiwo_torch.training.state import create_train_state

    cfg = {"task": "diffusion-unsup", "method": "diffusion", "mixed_precision": False}
    steps = DIFF_SMALL["timesteps"]
    rs = np.random.RandomState(5)
    x0 = torch.from_numpy(rs.randn(4, 32, 32, 2).astype(np.float32))
    t = torch.from_numpy(rs.randint(0, steps, 4))
    noise = torch.from_numpy(rs.randn(4, 32, 32, 2).astype(np.float32))
    noises = torch.from_numpy(rs.randn(steps + 1, 1, 32, 32, 2).astype(np.float32))
    res = {}
    zero_counters(counters)
    for dev in ("cuda", "cpu"):
        model = initialize_segmentation_model(cfg, DIFF_SMALL, device=dev, seed=2)
        chain = model.sample((1, 32, 32, 2), noises=noises).cpu()
        state = create_train_state(model, cfg, DIFF_SMALL)
        state, loss = make_diffusion_train_step(model, dev)(state, {"image": x0}, None, t=t,
                                                            noise=noise)
        res[dev] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()},
                    {k: p.detach().cpu() for k, p in model.named_parameters()}, chain)
    launched = read_counters(counters)
    (loss, grads, params, chain), (want_loss, want_grads, want_params, want_chain) = (
        res["cuda"], res["cpu"])
    out = {"loss_err": abs(loss - want_loss), "chain_err": (chain - want_chain).abs().max().item()}
    largest = max(g.abs().max().item() for g in want_grads.values())
    out["grad_err"] = 0.0
    for k, w in want_grads.items():
        err = (grads[k] - w).abs().max().item()
        require(err <= 1e-3 * w.abs().max().item() + 1e-5 * largest,
                f"diffusion card vs CPU: the gradient of {k} off by {err:.3e}")
        out["grad_err"] = max(out["grad_err"], err)
    out["param_err"], share = adam_step_close(params, want_params, DIFF_SMALL["learning_rate"])
    require(out["loss_err"] <= 1e-5 * abs(want_loss),
            f"diffusion card vs CPU: loss {loss} against {want_loss}")
    require(out["param_err"] <= 2 * DIFF_SMALL["learning_rate"] + 1e-7 and share >= 0.99,
            f"diffusion card vs CPU: Adam's update off by {out['param_err']:.3e} ({share:.4f} "
            "within 3e-4)")
    require(out["chain_err"] <= 1e-4 * max(1.0, want_chain.abs().max().item()),
            f"diffusion card vs CPU: the sample chain off by {out['chain_err']:.3e}")
    require(not any(launched.values()), f"the small DDPM launched {launched}")
    print(f"[diffusion parity] DDPM dim 16 (1, 2) 32^2 b4 f32, card against CPU: loss "
          f"{loss:.6f} (error {out['loss_err']:.3e}), gradients max error {out['grad_err']:.3e} "
          f"(largest {largest:.3e}), Adam's update max error {out['param_err']:.3e} ({share:.4f} "
          f"within 3e-4), 10-step sample chain max error {out['chain_err']:.3e}; no kernel "
          "launched", flush=True)
    return out


def diffusion_leg(torch, smi: str) -> tuple[dict, object]:
    """The shipped diffusion.json's bf16 train step (dim 64, dim_mults (1, 2,
    4, 8), 224^2 x 2, bf16 on f32 parameters) at the first of DIFF_BATCHES
    that fits, 2 warm-up and 5 timed steps: patches/s, peak memory, the
    card's busy time a step and its shares (torch.profiler, 2 steps): cuDNN
    and cuBLAS, against the elementwise passes and the reductions (the
    GroupNorms' statistics among them). Returns the numbers and the bench
    (its model for the sampler)."""
    import gc

    from kurosiwo_torch import bench

    warmup, steps = DIFF_STEPS
    for batch in DIFF_BATCHES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            b = bench.setup_diffusion(batch)
            one = bench._diffusion_train_fn(b)
            seconds, loss = bench._timed(one, steps, warmup, b.device)
        except torch.cuda.OutOfMemoryError:
            print(f"[diffusion main] train b{batch}: out of memory [{smi}]", flush=True)
            b = one = None
            gc.collect()
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(bool(torch.isfinite(loss).item()), f"diffusion b{batch} train loss {loss.item()}")
        ms = seconds / steps * 1e3
        prof = bench.profile(one, 2, b.device, ms, file=sys.stdout)
        cats, busy = prof["categories"], prof["kernel_ms"]
        share = {k: cats.get(c, 0.0) / busy for k, c in (
            ("cudnn_cublas", "convolution / matmul (cuDNN, cuBLAS)"),
            ("elementwise", "elementwise / copy"), ("reduction", "reduction"),
            ("optimizer", "optimizer"))}
        out = {"batch": batch, "rate": steps * batch / seconds, "ms": ms, "peak_gib": peak,
               "busy_ms": busy, "busy_share": busy / ms, "shares": share,
               "loss": loss.item()}
        print(f"[diffusion main] DDPM train b{batch} bf16 (dim 64, (1, 2, 4, 8), 224^2 x 2): "
              f"{out['rate']:.2f} patches/s ({ms:.2f} ms/step), loss {out['loss']:.5f}, peak "
              f"{peak:.2f} GiB, device busy {busy:.2f} ms/step ({100 * busy / ms:.1f}%): "
              f"cuDNN/cuBLAS {100 * share['cudnn_cublas']:.1f}%, elementwise "
              f"{100 * share['elementwise']:.1f}%, reductions {100 * share['reduction']:.1f}%, "
              f"Adam {100 * share['optimizer']:.1f}% [{smi}]", flush=True)
        b.state.model.zero_grad(set_to_none=True)
        return out, b
    raise PhaseFailed(f"the DDPM train step: no batch of {DIFF_BATCHES} fits")


def diffusion_sampler(torch, model, smi: str) -> dict:
    """One whole ``sample`` chain (the model's 1000 steps) at (1, 224, 224, 2)
    at full width, from a seeded generator on the card: its seconds (host
    clock, synchronised) and a finite output of the right shape (random
    weights: its scale is not a trained model's). Then 3 of its steps under
    torch.profiler: the card's busy time and the kernel launches a step."""
    from kurosiwo_torch import bench

    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = model.sample((1, IMAGE, IMAGE, 2), generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(tuple(x.shape) == (1, IMAGE, IMAGE, 2) and x.dtype == torch.float32
            and bool(torch.isfinite(x).all().item()),
            f"the sampler's output {tuple(x.shape)} {x.dtype}, finite "
            f"{bool(torch.isfinite(x).all().item())}")
    out = {"steps": model.timesteps, "seconds": seconds,
           "ms_per_step": seconds / model.timesteps * 1e3, "std": x.std().item()}
    gen.manual_seed(0)
    sampler = copy.copy(model)  # the same modules, a chain of 3 steps
    sampler.timesteps = 3
    prof = bench.profile(lambda: sampler.sample((1, IMAGE, IMAGE, 2), generator=gen), 1,
                         torch.device("cuda"), 3 * out["ms_per_step"], file=sys.stdout)
    out["busy_ms_per_step"], out["launches_per_step"] = prof["kernel_ms"] / 3, prof["launches"] / 3
    print(f"[diffusion sampler] {model.timesteps}-step chain at (1, {IMAGE}, {IMAGE}, 2), dim "
          f"64 bf16: {seconds:.2f} s ({out['ms_per_step']:.2f} ms a step), output finite, std "
          f"{out['std']:.4g}; a step keeps the card busy {out['busy_ms_per_step']:.2f} ms over "
          f"{out['launches_per_step']:.0f} kernel launches (torch.profiler, 3 steps) [{smi}]",
          flush=True)
    return out


def raster_inputs(torch, counters, smi: str, root) -> dict:
    """The raster CLI's inputs under ``root``: a RASTER_SIDE^2 VV/VH pair
    written as float32 TIFFs with cv2, and ``best_segmentation`` of the
    CLI's model (``load_config(method="unet")`` with inputs ["post_event"]:
    the shipped UNet-ResNet18 on 2 channels, bf16; the engine phase's UNet
    takes 6 channels, which the CLI's model cannot load) after 4 b32 train
    steps of an engine on synthetic batches. Then the CLI's steps in this
    process: the scene stacked and normalized, the model from
    ``load_variables``, ``predict_scene`` on the card under deterministic
    algorithms (as the CLI runs); its seconds and launches (none)."""
    import cv2
    import numpy as np
    from pathlib import Path

    from kurosiwo_torch import bench, inference
    from kurosiwo_torch.config import load_config
    from kurosiwo_torch.data.normalize import normalize
    from kurosiwo_torch.data.tiles import _imread, stack_channels
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.training.checkpoint import CheckpointManager
    from kurosiwo_torch.training.engine import TaskEngine

    rs = np.random.RandomState(21)
    side = (RASTER_SIDE, RASTER_SIDE)
    paths = {"vv": root / "vv.tif", "vh": root / "vh.tif"}
    for (name, path), scale in zip(paths.items(), (0.04, 0.01)):
        require(cv2.imwrite(str(path), rs.gamma(2.0, scale, side).astype(np.float32)),
                f"cv2 could not write {path}")
    cfg = load_config(method="unet", config_root=Path(__file__).resolve().parent / "configs",
                      overrides={"inputs": ["post_event"]})
    mc = cfg["model_config"]
    with backend_flags(torch):
        engine = TaskEngine(initialize_segmentation_model(cfg, mc, seed=7), cfg, mc,
                            "segmentation", steps_per_epoch=4)
        batch = bench.host_batch(32, seed=3)
        summary = engine.run_train_epoch([batch] * 4, 0)
        checkpoint = root / "run" / "best_segmentation"
        CheckpointManager(checkpoint.parent).save_best(engine.state, 0, 0.0)
        del engine
        scene = normalize(stack_channels(_imread(str(paths["vv"])), _imread(str(paths["vh"])),
                                         cfg["channels"], cfg.get("clamp_input")),
                          cfg["data_mean"], cfg["data_std"])
        model = initialize_segmentation_model(cfg, mc)
        model.load_state_dict(inference.load_variables(str(checkpoint), model))
        zero_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mask = inference.predict_scene(inference.TilePredictor(model), scene)
        seconds = time.perf_counter() - t0
        launched = read_counters(counters)
        del model
    torch.cuda.empty_cache()
    require(mask.shape == side and not any(launched.values()),
            f"the raster scene: mask {mask.shape}, launches {launched}")
    counts = {int(k): int(v) for k, v in zip(*np.unique(mask, return_counts=True))}
    print(f"[diffusion raster] {RASTER_SIDE}^2 VV/VH float32 TIFFs (cv2); best_segmentation of "
          f"the CLI's 2-channel UNet after 4 engine steps (train loss "
          f"{summary['mean_loss']:.5f}); in-process predict_scene on the card, deterministic: "
          f"{seconds:.2f} s, class pixel counts {counts}, no kernel launched [{smi}]", flush=True)
    return {"paths": paths, "checkpoint": checkpoint, "mask": mask, "seconds": seconds,
            "counts": counts}


def diffusion_cli_finish(res: dict, batch: int, smi: str) -> dict:
    """Of the CLI run ``python -m kurosiwo_torch --method diffusion --seed 7
    --batch_size <batch>`` with ``"task": "diffusion-unsup"`` in a copy of
    the shipped configs (a ``cli_collect`` result): exit 0, finite printed
    losses, diffusion_0 written."""
    import re

    written = sorted(f.rsplit("/", 1)[-1] for f in res["files"] if f.endswith(".ptr.json"))
    losses = [float(x) for x in re.findall(r"^diffusion epoch \d+ iter \d+: loss=(\S+)$",
                                           res["stdout"], re.M)]
    if res["rc"] or not losses:
        print(res["stdout"][-3000:], res["stderr"][-3000:], sep="\n", flush=True)
    require(res["rc"] == 0, f"the diffusion CLI exited {res['rc']}")
    require(losses and all(math.isfinite(x) for x in losses),
            f"the diffusion CLI's losses {losses}")
    require("diffusion_0.ptr.json" in written, f"the diffusion CLI wrote {written}")
    print(f"[diffusion cli] python -m kurosiwo_torch --method diffusion --seed 7 --batch_size "
          f"{batch} (\"task\": \"diffusion-unsup\", shipped diffusion.json): exit 0 in "
          f"{res['seconds']:.1f} s ({res['at_once']} at once at most), losses {losses}, wrote "
          f"{written} [{smi}]", flush=True)
    return {"seconds": res["seconds"], "losses": losses, "batch": batch}


def raster_cli_finish(res: dict, raster: dict, out, smi: str) -> dict:
    """Of the raster CLI run (a ``cli_collect`` result): exit 0, the mask PNG
    bitwise the in-process ``predict_scene``'s mask, the overlay written,
    the printed line's size and class counts the mask's."""
    import re

    import cv2
    import numpy as np

    if res["rc"]:
        print(res["stdout"][-3000:], res["stderr"][-3000:], sep="\n", flush=True)
    require(res["rc"] == 0, f"the raster CLI exited {res['rc']}")
    written = cv2.imread(str(out.with_suffix(".mask.png")), cv2.IMREAD_UNCHANGED)
    require(written is not None and out.is_file(), f"the raster CLI wrote no mask or overlay "
            f"({out.with_suffix('.mask.png')}, {out})")
    equal = bool(np.array_equal(written, raster["mask"]))
    require(equal, f"the raster CLI's mask differs from predict_scene's in "
            f"{int((written != raster['mask']).sum())} pixels")
    line = re.search(r"^scene (\d+)x(\d+); class pixel counts: (\{.*\}); wrote", res["stdout"],
                     re.M)
    require(line is not None and line.group(3) == str(raster["counts"])
            and line.group(1) == line.group(2) == str(RASTER_SIDE),
            f"the raster CLI printed {line.group(0) if line else res['stdout'][-500:]}")
    print(f"[diffusion raster cli] python -m kurosiwo_torch.inference --vv --vh --checkpoint "
          f"<dir>/best_segmentation on {RASTER_SIDE}^2: exit 0 in {res['seconds']:.1f} s "
          f"({res['at_once']} at once at most), mask bitwise the in-process predict_scene's, "
          f"overlay written, printed {line.group(0)!r} [{smi}]", flush=True)
    return {"seconds": res["seconds"], "mask_equal": equal}


def phase_diffusion(torch, counters, smi: str, cli: list) -> dict:
    """Diffusion pretraining (A10) and the raster CLI (A11): the DDPM card
    against CPU (``diffusion_card_vs_cpu``); the full-width train leg
    (``diffusion_leg``) and the 1000-step sampler (``diffusion_sampler``),
    every kernel counter 0 across both; the raster CLI's inputs and its
    in-process map (``raster_inputs``); adds to ``cli`` the diffusion CLI at
    the leg's batch and the raster CLI. Returns the numbers of each."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    out = {"parity": diffusion_card_vs_cpu(torch, counters)}
    marks = {"parity": time.perf_counter() - t0}
    zero_counters(counters)
    with backend_flags(torch):  # the diffusion task's deterministic algorithms
        out["main"], b = diffusion_leg(torch, smi)
        marks["leg"] = time.perf_counter() - t0 - sum(marks.values())
        out["sampler"] = diffusion_sampler(torch, b.state.model, smi)
    out["launches"] = read_counters(counters)
    require(not any(out["launches"].values()),
            f"the diffusion step and sampler launched {out['launches']}")
    del b
    torch.cuda.empty_cache()
    marks["sampler"] = time.perf_counter() - t0 - sum(marks.values())
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    raster = raster_inputs(torch, counters, smi, root)
    marks["raster"] = time.perf_counter() - t0 - sum(marks.values())

    batch = out["main"]["batch"]
    # the CLI's peak is the leg's (plus its context), run alone where it passes the budget
    CLI_GIB["diffusion"] = min(CLI_BUDGET_GIB, math.ceil(out["main"]["peak_gib"]) + 1)
    extra = ("--batch_size", str(batch)) if batch != BATCH else ()
    cli.append(CliJob([({"task": "diffusion-unsup"}, ("diffusion",), extra)],
                      lambda results: out.update(cli=diffusion_cli_finish(results[0], batch,
                                                                          smi))))
    tif = raster["paths"]
    flood = root / "cli" / "flood.png"
    flood.parent.mkdir()
    argv = ("--vv", str(tif["vv"]), "--vh", str(tif["vh"]), "--checkpoint",
            str(raster["checkpoint"]), "--out", str(flood))

    def raster_check(results: list) -> None:
        try:
            out["raster_cli"] = raster_cli_finish(results[0], raster, flood, smi)
        finally:
            tmp.cleanup()

    cli.append(CliJob([(None, ("raster",), argv, "kurosiwo_torch.inference")], raster_check))
    out["raster"] = {"seconds": raster["seconds"], "counts": raster["counts"]}
    out["wall_s"] = time.perf_counter() - t0
    print(f"[diffusion] phase wall {out['wall_s']:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in marks.items())}; its two CLI runs in the "
          f"CLI pool) [{smi}]", flush=True)
    return out


# the weights phase (A13): weights from the reference's files, at the main
# path's width. The files are written from the port's own seeded models in
# the reference's key layouts (torchvision's ResNet, smp's UNet); the
# leg's train steps, its f32 eval and the parity harness's split are cut
# short (2 steps, 1 eval batch, 64 test samples), the widths are not.
WEIGHTS_SEED = 17
WEIGHTS_TEST_SAMPLES = 64
# train steps a timed turn of the loaded engine and its random-init twin (6
# gave turns 19% apart on one card, wider than the two engines' difference)
WEIGHTS_TURN_STEPS = 20
WEIGHTS_PARITY_BATCH = 32
# the parity harness, card against the CPU's plain versions on one split:
# each confusion count within 0.1% of the split's valid pixels, F1 and IoU
# within 0.1 points (f32 on both; argmax flips only at near-ties)
WEIGHTS_CM_BAND = 1e-3
WEIGHTS_SCORE_BAND = 0.1
_BN_REF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def reference_layout(state: dict, prefix: str = "") -> dict:
    """The port's ResNet-encoder (``prefix`` "encoder.": UNet) state_dict
    under torchvision's and smp's keys: the stem's conv1/bn1, a BasicBlock's
    conv1/bn1, conv2/bn2 and downsample.0/.1, smp's decoder.blocks.{i}.
    conv{1,2}.{0,1} and segmentation_head.0; each BatchNorm with its
    num_batches_tracked, as torch saves them."""
    import re

    import torch

    out = {}
    for key, value in state.items():
        name, leaf = key.rsplit(".", 1)
        bn = name.endswith("BatchNorm_0")
        ref_leaf = _BN_REF[leaf] if bn else leaf
        m = re.fullmatch(rf"{re.escape(prefix)}layer(\d)_(\d+)\.ConvBNAct_(\d)\.(Conv_0|BatchNorm_0)",
                         name)
        if name == f"{prefix}stem.Conv_0" or name == f"{prefix}stem.BatchNorm_0":
            ref = f"{prefix}{'bn1' if bn else 'conv1'}"
        elif m:
            c = int(m[3])
            part = (f"downsample.{int(bn)}" if c == 2 else f"{'bn' if bn else 'conv'}{c + 1}")
            ref = f"{prefix}layer{m[1]}.{m[2]}.{part}"
        elif d := re.fullmatch(r"DecoderBlock_(\d)\.ConvBNAct_(\d)\.(Conv_0|BatchNorm_0)", name):
            ref = f"decoder.blocks.{d[1]}.conv{int(d[2]) + 1}.{int(bn)}"
        elif name == "head":
            ref = "segmentation_head.0"
        else:
            raise KeyError(f"no reference key for {key}")
        out[f"{ref}.{ref_leaf}"] = value.detach().cpu().clone()
        if bn and leaf == "var":
            out[f"{ref}.num_batches_tracked"] = torch.tensor(1000)
    return out


def weights_files(torch, root) -> dict:
    """A seeded 3-channel torchvision-layout ResNet-18 .pth and a seeded
    full-width 6-channel smp-layout UNet-ResNet18 .pt under ``root``, from
    the port's seeded init with BatchNorm's affine and statistics perturbed
    (scale 1 + 0.2 N, bias and mean 0.1 N, var 0.5 + U), so that an eval
    is not an identity. Returns the paths and the port-named state of each,
    checked to come back through the port's converters bit for bit."""
    from kurosiwo_torch import convert
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.models.resnet import ResNetEncoder

    g = torch.Generator().manual_seed(WEIGHTS_SEED)

    def perturbed(state: dict) -> dict:
        out = {}
        for k, v in state.items():
            leaf = k.rsplit(".", 1)[-1]
            if ".BatchNorm_0." in k and leaf in ("scale", "var"):
                v = (1 + 0.2 * torch.randn(v.shape, generator=g) if leaf == "scale"
                     else 0.5 + torch.rand(v.shape, generator=g))
            elif ".BatchNorm_0." in k:
                v = 0.1 * torch.randn(v.shape, generator=g)
            out[k] = v.detach().float().contiguous()
        return out

    encoder = perturbed(ResNetEncoder(3, "resnet18", generator=g).state_dict())
    cfg = {"method": "unet", "num_classes": 3, "num_channels": 6, "mixed_precision": True}
    unet = perturbed(initialize_segmentation_model(cfg, {"backbone": "resnet18"}, device="cpu",
                                                   seed=WEIGHTS_SEED).state_dict())
    paths = {"encoder": root / "resnet18_imagenet.pth", "unet": root / "best_segmentation.pt"}
    torch.save(reference_layout(encoder), paths["encoder"])
    torch.save({"model_state_dict": reference_layout(unet, "encoder."), "epoch": 0},
               paths["unet"])
    for got, want in ((convert.convert_torchvision_resnet(
            convert.load_torch_state_dict(paths["encoder"])), encoder),
            (convert.convert(paths["unet"], "unet"), unet)):
        require(sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want),
                "a reference-layout file does not come back through the port's converter")
    return {"paths": paths, "encoder": encoder, "unet": unet}


def weights_config_root(root, pth) -> "Path":
    """A copy of the shipped configs whose method/unet/unet.json names the
    torchvision file as ``pretrained_encoder`` (b128, 224x224, bf16, its
    ``pretrained`` and ``encoder_weights`` as shipped)."""
    import shutil
    from pathlib import Path

    from kurosiwo_torch.config import load_json5

    configs = root / "configs"
    shutil.copytree(Path(__file__).resolve().parent / "configs", configs)
    path = configs / "method" / "unet" / "unet.json"
    path.write_text(json.dumps({**load_json5(path), "pretrained_encoder": str(pth)}))
    return configs


def weights_encoder_leg(torch, counters, smi: str, files: dict, configs, main_rate: float) -> dict:
    """The pretrained_encoder leg in-process: load_config(unet, resnet18) on
    ``configs`` (the .pth as unet.json's pretrained_encoder), the engine on
    the card (b128, 224x224, bf16, the f32 eval twin); the encoder bitwise
    the file's before step 1 (its 3-channel stem leaves the 6-channel stem
    at its init); 2 train steps and one f32 eval batch, counted: 60
    pair_sums and one CE+cm launch each way a step, two CE+cm forwards an
    eval batch; then the train step on those batches resident on the card,
    timed in turns against a twin engine of the same config from its random
    init, beside the main path's step rate ``main_rate``. The load's seconds are
    those of a second load into the same engine (the file in the page
    cache)."""
    from kurosiwo_torch.config import load_config
    from kurosiwo_torch.data.pipeline import Loader
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.training import engine as eng

    cfg = load_config(method="unet", backbone="resnet18", config_root=configs,
                      overrides={"synthetic_size": 2 * BATCH})
    mcfg = cfg["model_config"]
    require(cfg["pretrained_encoder"] == str(files["paths"]["encoder"]) and cfg["batch_size"] == BATCH
            and cfg["mixed_precision"] and cfg["pretrained"],
            f"weights config: pretrained_encoder {cfg.get('pretrained_encoder')}, batch "
            f"{cfg['batch_size']}, mixed_precision {cfg['mixed_precision']}")

    def held(mode: str, n: int) -> list:
        loader = Loader(mode, dict(cfg, synthetic_size=n), WEIGHTS_SEED)
        out = []
        for b in loader.ring_batches():
            out.append({k: v.copy() for k, v in b.items()})
            b.release()
        loader.close()
        return out

    train, val = held("train", 2 * BATCH), held("val", BATCH)
    model = initialize_segmentation_model(cfg, mcfg, seed=WEIGHTS_SEED)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    engine = eng.TaskEngine(model, cfg, mcfg, "segmentation", steps_per_epoch=len(train),
                            seed=WEIGHTS_SEED)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    loaded = {k: v.detach().cpu() for k, v in engine.state.model.state_dict().items()}
    for k, v in loaded.items():
        name = k[len("encoder."):]
        want = (init[k] if (not k.startswith("encoder.") or name.startswith("stem."))
                else files["encoder"][name])
        require(torch.equal(v, want), f"before step 1, {k} is not "
                                      f"{'its init' if want is init.get(k) else 'the file'}'s")
    t0 = time.perf_counter()
    engine._load_pretrained_weights()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    zero_counters(counters)
    summary = engine.run_train_epoch(train, 0)
    acc, f1, miou, ev = engine.run_eval(val, "Val")
    torch.cuda.synchronize()
    launches = read_counters(counters)
    want = {name: 0 for name in counters}
    want.update(pair_sums=60 * len(train), ce_cm_fwd_nhwc=len(train) + 2 * len(val),
                ce_cm_bwd_nhwc=len(train))
    require(launches == want, f"weights leg launches {launches}, expected {want}")
    require(math.isfinite(summary["mean_loss"]) and math.isfinite(miou),
            f"weights leg loss {summary['mean_loss']}, val mIoU {miou}")
    # the step alone, as bench.run_train times the main path's (batches
    # resident on the card, synchronised), beside a twin engine of the same
    # config from its random init, in turns: loaded, twin, twin, loaded
    import warnings

    from kurosiwo_torch.ops.metrics import MetricState

    def step_rate(e, steps: int) -> float:
        state, metric, lr = e.state, MetricState.create(e.device), float(e.lr_schedule(1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            state, metric, _ = e._train_step(state, resident[i % len(resident)], metric, lr,
                                             e.generator)
        torch.cuda.synchronize()
        return steps * BATCH / (time.perf_counter() - t0)

    resident = list(eng.device_prefetch(train, engine.device))
    twin_cfg = {k: v for k, v in cfg.items() if k != "pretrained_encoder"}
    with warnings.catch_warnings():  # the shipped unet.json asks for weights it is not given
        warnings.simplefilter("ignore")
        twin = eng.TaskEngine(initialize_segmentation_model(twin_cfg, mcfg, seed=WEIGHTS_SEED),
                              twin_cfg, mcfg, "segmentation", steps_per_epoch=len(train),
                              seed=WEIGHTS_SEED)
    for e in (engine, twin):
        step_rate(e, 3)
    turns = [step_rate(e, WEIGHTS_TURN_STEPS) for e in (engine, twin, twin, engine)]
    rate, twin_rate = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    out = {"build_s": build_s, "load_s": load_s, "launches": launches,
           "loss": summary["mean_loss"], "val_miou": miou, "rate": rate, "turns": turns,
           "random_init_rate": twin_rate, "main_path_rate": main_rate, "steps": len(train),
           "eval_batches": len(val)}
    print(f"[weights] pretrained_encoder {files['paths']['encoder'].name} (3-channel torchvision "
          f"ResNet-18) into UNet-ResNet18 (6 channels): the encoder bitwise the file's before "
          f"step 1, the stem at its init; engine built in {build_s:.3f} s, the load alone "
          f"{load_s:.3f} s (warm file); {len(train)} b{BATCH} train steps, loss "
          f"{summary['mean_loss']:.5f}, one f32 eval batch, val mIoU {miou:.4f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; the train step on the loaded "
          f"weights {rate:.2f} patches/s, the same config from its random init "
          f"{twin_rate:.2f} ({WEIGHTS_TURN_STEPS} steps a turn, batches on the card, in turns "
          f"loaded, random, "
          f"random, loaded: {', '.join(f'{r:.2f}' for r in turns)}; the main path's "
          f"{main_rate:.2f}) [{smi}]",
          flush=True)
    del engine, model, resident, twin
    torch.cuda.empty_cache()
    return out


def weights_parity_args(files: dict, device: str) -> list:
    """The parity harness's flags on the UNet .pt (the shipped configs,
    the CLI pool's run adds its --config_root)."""
    return ["--checkpoint", str(files["paths"]["unet"]), "--model", "unet",
            "--batch_size", str(WEIGHTS_PARITY_BATCH), "--seed", str(WEIGHTS_SEED),
            "--override", json.dumps({"synthetic_size": WEIGHTS_TEST_SAMPLES, "num_workers": 4}),
            "--device", device]


def parity_close(got: dict, want: dict, tag: str) -> dict:
    """The parity band (WEIGHTS_CM_BAND, WEIGHTS_SCORE_BAND) between two
    harness reports; returns the largest differences."""
    import numpy as np

    cm, wcm = np.asarray(got["test_confusion"]), np.asarray(want["test_confusion"])
    pixels = int(wcm.sum())
    diff = {"cm_max": int(np.abs(cm - wcm).max()), "pixels": pixels,
            "scores_max": max(abs(got[k] - want[k]) for k in
                              ("test_accuracy", "test_mean_f1", "test_mean_iou")),
            "per_class_max": float(np.abs(np.subtract(got["per_class_f1"] + got["per_class_iou"],
                                                      want["per_class_f1"]
                                                      + want["per_class_iou"])).max())}
    require(int(cm.sum()) == pixels > 0 and diff["cm_max"] <= WEIGHTS_CM_BAND * pixels
            and diff["scores_max"] <= WEIGHTS_SCORE_BAND
            and diff["per_class_max"] <= WEIGHTS_SCORE_BAND,
            f"{tag}: the parity reports differ beyond the band: {diff}")
    return diff


def phase_weights(torch, counters, smi: str, cli: list, step_rate: float) -> dict:
    """Weights from the reference's files (A13) on the card: the files
    (``weights_files``), the pretrained_encoder leg (``weights_encoder_leg``)
    and the parity harness on the .pt over a small synthetic test split,
    in-process on the card (B2's forward counted) and on the CPU (plain
    versions), held to each other in the band; adds to ``cli`` ``python -m
    kurosiwo_torch --method unet --backbone resnet18`` on the config root
    whose unet.json names the .pth (exit 0, the load printed, a test mIoU)
    and ``python -m kurosiwo_torch.parity --model unet`` on the .pt (its
    report held to the CPU's in the band)."""
    import os
    import tempfile
    from pathlib import Path

    from kurosiwo_torch import parity

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    files = weights_files(torch, root)
    configs = weights_config_root(root, files["paths"]["encoder"])
    marks = {"files": time.perf_counter() - t0}
    out = {"encoder": weights_encoder_leg(torch, counters, smi, files, configs, step_rate)}
    marks["encoder leg"] = time.perf_counter() - t0 - sum(marks.values())

    shipped = ["--config_root", str(Path(__file__).resolve().parent / "configs")]
    cwd = os.getcwd()
    os.chdir(root)  # the shipped root_path is relative: no corpus here, the synthetic split
    try:
        zero_counters(counters)
        t1 = time.perf_counter()
        card = parity.run(parity.build_parser().parse_args(
            weights_parity_args(files, "cuda") + shipped))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        launches = read_counters(counters)
        batches = math.ceil(WEIGHTS_TEST_SAMPLES / WEIGHTS_PARITY_BATCH)
        want = {name: 0 for name in counters}
        want["ce_cm_fwd_nhwc"] = 2 * batches
        require(launches == want, f"the parity harness on the card launched {launches}, "
                                  f"expected {want}")
        t1 = time.perf_counter()
        cpu = parity.run(parity.build_parser().parse_args(
            weights_parity_args(files, "cpu") + shipped))
        cpu_s = time.perf_counter() - t1
    finally:
        os.chdir(cwd)
    torch.cuda.empty_cache()
    diff = parity_close(card, cpu, "parity card vs CPU")
    out["parity"] = {"card": {k: card[k] for k in ("test_mean_f1", "test_mean_iou")},
                     "card_s": card_s, "cpu_s": cpu_s, "launches": launches,
                     "card_vs_cpu": diff}
    print(f"[weights] python -m kurosiwo_torch.parity --model unet on {files['paths']['unet'].name} "
          f"(full-width smp UNet-ResNet18, 6 channels), {WEIGHTS_TEST_SAMPLES} synthetic test "
          f"samples at b{WEIGHTS_PARITY_BATCH}, in-process: card {card_s:.1f} s (test F1 "
          f"{card['test_mean_f1']:.4f}, mIoU {card['test_mean_iou']:.4f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }), CPU {cpu_s:.1f} s; card vs CPU: "
          f"confusion counts at most {diff['cm_max']} of {diff['pixels']} pixels apart (band "
          f"{WEIGHTS_CM_BAND:.1%}), scores {diff['scores_max']:.2e} points (band "
          f"{WEIGHTS_SCORE_BAND}) [{smi}]", flush=True)
    marks["parity"] = time.perf_counter() - t0 - sum(marks.values())

    def encoder_check(results: list) -> None:
        run = cli_finish(results[0])
        loaded = f"Loaded pretrained_encoder {files['paths']['encoder']}"
        require(loaded in results[0]["stdout"], "the CLI did not print its pretrained_encoder load")
        out["cli"] = {"seconds": run["seconds"], "miou": run["miou"]}
        print(f"[weights cli] python -m kurosiwo_torch --method unet --backbone resnet18 "
              f"(unet.json's pretrained_encoder the .pth): exit 0 in {run['seconds']:.1f} s "
              f"({run['at_once']} at once at most), '{loaded}' printed, Test Mean IOU "
              f"{run['miou']:.4f} [{smi}]", flush=True)

    def parity_check(results: list) -> None:
        res = results[0]
        try:
            if res["rc"]:
                print(res["stdout"][-3000:], res["stderr"][-3000:], sep="\n", flush=True)
            require(res["rc"] == 0, f"the parity CLI exited {res['rc']}")
            report = json.loads(res["stdout"][res["stdout"].index("{"):])
            diff = parity_close(report, cpu, "the parity CLI vs the CPU")
            out["parity_cli"] = {"seconds": res["seconds"], "card_vs_cpu": diff,
                                 "same_as_in_process": report["test_confusion"]
                                 == card["test_confusion"]}
            print(f"[weights parity cli] python -m kurosiwo_torch.parity --model unet: exit 0 in "
                  f"{res['seconds']:.1f} s ({res['at_once']} at once at most), test F1 "
                  f"{report['test_mean_f1']:.4f}; against the CPU run: counts at most "
                  f"{diff['cm_max']} pixels apart, scores {diff['scores_max']:.2e} points; the "
                  f"in-process card run's counts "
                  f"{'equal' if out['parity_cli']['same_as_in_process'] else 'differ'} [{smi}]",
                  flush=True)
        finally:
            tmp.cleanup()

    cli.append(CliJob([(None, ("unet", "resnet18"), (), "kurosiwo_torch", configs)],
                      encoder_check))
    cli.append(CliJob([(None, ("parity",), tuple(weights_parity_args(files, "cuda")),
                        "kurosiwo_torch.parity")], parity_check))
    out["wall_s"] = time.perf_counter() - t0
    print(f"[weights] phase wall {out['wall_s']:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in marks.items())}; its two CLI runs in the "
          f"CLI pool) [{smi}]", flush=True)
    return out


def slice_summary(mae: dict | None, rec: dict | None, smi: str,
                  diff: dict | None = None, weights: dict | None = None) -> str:
    """One line of the MAE-loop, recurrent, diffusion and weights phases'
    numbers, printed near the end."""
    line: dict = {"card": smi}
    if mae is not None:
        line["mae_train"] = {"loop": mae["main"], "b4": mae["b4"], "cli": mae["cli"],
                             "card_vs_cpu_launches": mae["parity"], "phase_wall_s": mae["wall_s"]}
    if rec is not None:
        line["recurrent"] = {"legs": _legs({"convlstm": rec["convlstm"]}), "b2": rec["b2"],
                             "fused_tail_launches": rec["fused_tail"], "cli_test_miou": rec["cli"],
                             "phase_wall_s": rec["wall_s"]}
    if diff is not None:
        line["diffusion"] = {"card_vs_cpu": diff["parity"], "train": diff["main"],
                             "sampler": diff["sampler"], "kernel_launches": diff["launches"],
                             "raster_in_process": diff["raster"], "cli": diff.get("cli"),
                             "raster_cli": diff.get("raster_cli"), "phase_wall_s": diff["wall_s"]}
    if weights is not None:
        line["weights"] = {"pretrained_encoder": weights["encoder"], "parity": weights["parity"],
                           "cli": weights.get("cli"), "parity_cli": weights.get("parity_cli"),
                           "phase_wall_s": weights["wall_s"]}
    return "[slice summary] " + json.dumps(line)


# The CLI runs that the phases ask for run in one pool after the last phase,
# beside no timed step: at most CLI_AT_ONCE processes at once whose estimated
# peaks (CLI_GIB) sum to at most CLI_BUDGET_GIB, the largest first. Each
# estimate is the larger of the model's train and f32-eval peaks in its leg
# of this script (b128; the finetuner's b64), rounded up, plus 1 GiB for the
# process's own CUDA context (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md). No
# two runs of 36 GiB and more fit the budget together, so each of those runs
# beside smaller ones. The raster CLI's is the UNet's eval at b32; the
# diffusion CLI's is set by its phase from its leg's peak (at most the
# budget: then it runs alone); the parity harness's is the raster CLI's (the
# same UNet eval at b32, in f32).
CLI_BUDGET_GIB = 62
CLI_GIB = {"unet": 7, "snunet": 22, "bit-cd": 10, "transunet-cd": 39, "changeformer": 36,
           "unet++": 10, "deeplabv3": 6, "upernet": 16, "finetune": 37, "convlstm": 23, "mae": 8,
           "raster": 6, "diffusion": CLI_BUDGET_GIB, "parity": 6}
CLI_AT_ONCE = 6
CLI_TIMEOUT_S = 600
# runs this large pair with no other of their size, so they follow one
# another and set the pool's wall time: the smaller runs beside them take a
# lower CPU priority (nice 10), so that the host's cores serve the large
# ones first (a run's start-up is CPU work, torch's imports: on an NVIDIA
# H100 80GB HBM3 host whose CPU ran slow, runs of 25-42 s took 45-65 s six
# at once)
CLI_BIG_GIB = CLI_BUDGET_GIB // 2


class CliJob:
    """CLI runs that a phase asks for (``specs``: (config, method, extra[,
    module]) each, as ``cli_start`` takes them) and ``check``, which ``phase_cli``
    calls with their ``cli_collect`` results, in the order of ``specs``,
    once the pool has run them all."""

    def __init__(self, specs: list[tuple], check):
        self.specs, self.check = specs, check


def cli_start(config: dict | None = None, method: tuple = ("unet", "resnet18"),
              extra: tuple = (), module: str = "kurosiwo_torch", configs=None,
              nice: int = 0) -> dict:
    """Starts ``python -m kurosiwo_torch --method unet --backbone resnet18
    --seed 7`` (``method``: the method and backbone; a method without a
    backbone takes its model config's; ``extra``: more flags) in a
    subprocess and a temporary directory, on a copy of the shipped configs
    with ``config`` merged into train/train_config.json, the last file
    merged (none: the shipped files as they are; ``configs``: another
    config root in their place); it reuses the kernels
    already built, and writes its stdout and stderr to files there. The
    run's allocator takes expandable segments (PYTORCH_CUDA_ALLOC_CONF), so
    that the memory it holds stays near what it allocates. Another
    ``module`` (the raster CLI, ``kurosiwo_torch.inference``) takes
    ``extra`` as its flags; ``method[0]`` then only names the run. ``nice``
    lowers the run's CPU priority (and its decode processes')."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    # the allocator maps what a run uses, so that the pool's estimates hold
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               PYTHONPATH=os.pathsep.join([str(root)] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    argv = ([*extra] if module != "kurosiwo_torch" else
            ["--method", method[0], *(["--backbone", method[1]] if method[1:] else []), *extra,
             "--seed", "7"])
    tmp = tempfile.TemporaryDirectory()
    configs = Path(configs) if configs is not None else root / "configs"
    if config:
        from kurosiwo_torch.config import load_json5

        shutil.copytree(configs, Path(tmp.name) / "configs")
        configs = Path(tmp.name) / "configs"
        path = configs / "train" / "train_config.json"
        path.write_text(json.dumps({**load_json5(path), **config}))
    with open(Path(tmp.name) / "cli.stdout", "w") as so, \
            open(Path(tmp.name) / "cli.stderr", "w") as se:
        proc = subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--config_root", str(configs)],
            cwd=tmp.name, env=env, stdout=so, stderr=se)
    if nice:
        os.setpriority(os.PRIO_PROCESS, proc.pid, nice)
    return {"proc": proc, "tmp": tmp, "t0": time.perf_counter(), "argv": argv, "at_once": 1}


def cli_collect(run: dict) -> dict:
    """The result of a ``cli_start`` run that has ended (``run["end"]``: when
    the pool saw it end): its exit code, stdout, stderr, seconds, the files
    it wrote under checkpoints/ and the most runs that went at once while it
    ran. Its directory is removed."""
    from pathlib import Path

    proc, tmp = run["proc"], run["tmp"]
    proc.wait()
    root = Path(tmp.name)
    ckpt = root / "checkpoints"
    written = sorted(str(f.relative_to(root)) for f in ckpt.rglob("*")
                     if f.is_file()) if ckpt.exists() else []
    res = {"rc": proc.returncode, "stdout": (root / "cli.stdout").read_text(),
           "stderr": (root / "cli.stderr").read_text(), "seconds": run["end"] - run["t0"],
           "files": written, "at_once": run["at_once"]}
    tmp.cleanup()
    return res


def cli_finish(res: dict) -> dict:
    """Exit 0 and a ``Test Mean IOU:`` line, required of a ``cli_collect``
    result. Returns the seconds, the test mIoU, the JSON lines it printed
    (with on_screen_prints), the files it wrote under checkpoints/ and the
    most runs at once."""
    import re

    found = re.search(r"^Test Mean IOU:\s+(\S+)$", res["stdout"], re.M)
    if res["rc"] or not found:
        print(res["stdout"][-3000:], res["stderr"][-3000:], sep="\n", flush=True)
    require(res["rc"] == 0, f"the CLI exited {res['rc']}")
    require(found is not None, "the CLI printed no 'Test Mean IOU:' line")
    miou = float(found.group(1))
    require(math.isfinite(miou) and 0.0 <= miou <= 100.0, f"the CLI's test mIoU {miou}")
    lines = [json.loads(x) for x in res["stdout"].splitlines() if x.startswith('{"')]
    return {"seconds": res["seconds"], "miou": miou, "lines": lines, "files": res["files"],
            "at_once": res["at_once"]}


def cli_pair_check(tag: str, method: str, flags: str, smi: str, results: list,
                   note: str = "", epoch_checkpoint: bool = True) -> list:
    """The repeatability check of a pair of deterministic CLI runs of one
    command (``cli_finish`` each): with ``epoch_checkpoint`` (the cd and
    recurrent tasks) each wrote ``checkpoint_epoch=0``, and both printed the
    same numbers (every JSON line but its times, the test mIoU). Prints one
    line a run; returns their ``cli_finish`` results."""
    runs, done = [], []
    for res in results:
        run = cli_finish(res)
        require(not epoch_checkpoint or any(f.endswith("checkpoint_epoch=0.ptr.json")
                                            for f in run["files"]),
                f"the {method} CLI left no checkpoint_epoch=0: {run['files']}")
        first = next(x for x in run["lines"] if x.get("Iteration") == 0)["Train Loss"]
        runs.append({"first": first, "lines": [
            {k: v for k, v in x.items() if "time" not in k} for x in run["lines"]],
            "miou": run["miou"]})
        done.append(run)
        print(f"[{tag} cli] python -m kurosiwo_torch --method {method} {flags}--seed 7{note}: "
              f"exit 0 in {run['seconds']:.1f} s ({run['at_once']} at once at most), first-step loss "
              f"{first}, Test Mean IOU {run['miou']!r}"
              f"{', checkpoint_epoch=0 written' if epoch_checkpoint else ''} [{smi}]", flush=True)
    require(runs[0] == runs[1], f"two deterministic {method} CLI runs at one seed differ")
    print(f"[{tag}] the two {method} CLI runs agree in every printed number", flush=True)
    return done


def smi_used_gib() -> float:
    """The card's memory in use by every process (nvidia-smi), GiB."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30).stdout
    return float(out.split()[0]) / 1024


def phase_cli(torch, jobs: list, smi: str) -> None:
    """Runs every ``CliJob``'s runs in one pool (CLI_GIB: the runs of
    CLI_BIG_GIB and more first, the largest first, then the others in the
    order of ``jobs``; at most CLI_AT_ONCE at once, their estimates within
    CLI_BUDGET_GIB, the runs under CLI_BIG_GIB at a lower CPU priority; each
    given CLI_TIMEOUT_S), then each job's check, in the order of ``jobs``.
    Prints the pool's wall time, the most runs at once and the card's memory
    in use at most (nvidia-smi, every 2 s)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2**30
    runs = [spec for job in jobs for spec in job.specs]
    gib = [CLI_GIB[spec[1][0]] for spec in runs]
    # the large runs, which follow one another, from the largest; the others
    # in the order the phases asked for them (C14's autotuning runs first)
    big = sorted((k for k in range(len(runs)) if gib[k] >= CLI_BIG_GIB), key=lambda k: -gib[k])
    pending = big + [k for k in range(len(runs)) if k not in big]
    going: dict = {}
    results: dict = {}
    t0 = last = time.perf_counter()
    used_max, most = smi_used_gib(), 0
    try:
        while pending or going:
            for k in list(pending):
                if len(going) >= CLI_AT_ONCE:
                    break
                if sum(gib[i] for i in going) + gib[k] <= CLI_BUDGET_GIB:
                    going[k] = cli_start(*runs[k], nice=0 if gib[k] >= CLI_BIG_GIB else 10)
                    pending.remove(k)
            most = max(most, len(going))
            for run in going.values():
                run["at_once"] = max(run["at_once"], len(going))
            time.sleep(0.25)
            now = time.perf_counter()
            if now - last >= 2.0:
                used_max, last = max(used_max, smi_used_gib()), now
            for k in [k for k, run in going.items() if run["proc"].poll() is not None]:
                going[k]["end"] = now
                results[k] = cli_collect(going.pop(k))
            late = [run for run in going.values() if now - run["t0"] > CLI_TIMEOUT_S]
            require(not late, f"a CLI run ({' '.join(late[0]['argv']) if late else ''}) took "
                              f"over {CLI_TIMEOUT_S} s")
    finally:
        for run in going.values():
            if run["proc"].poll() is None:
                run["proc"].kill()
            run["proc"].wait()
            run["tmp"].cleanup()
    print(f"[cli pool] {len(runs)} CLI runs in {time.perf_counter() - t0:.1f} s, at most {most} "
          f"at once (estimated peaks within {CLI_BUDGET_GIB} GiB), the card's memory in use at "
          f"most {used_max:.1f} GiB (nvidia-smi, every 2 s; this process holds {held:.2f} GiB) "
          f"[{smi}]", flush=True)
    k = 0
    for job in jobs:
        job.check([results[k + i] for i in range(len(job.specs))])
        k += len(job.specs)


def c14_cli(smi: str) -> CliJob:
    """The CLI on the shipped configs as they are (b128, 1 epoch, the
    default synthetic splits of 256/64/64, AOI banks on), and ROADMAP C14:
    the CLI at one seed, twice with cuDNN's autotuner (deterministic: false)
    and twice with deterministic algorithms (deterministic: true),
    on_screen_prints on; the five in the pool. Its check prints each C14
    run's first-step loss, the train epoch's and the val eval's metrics
    (functions of their banks) and the test mIoU; the two deterministic
    runs must agree in all of them."""
    dets = (False, False, True, True)
    specs = [(None, ("unet", "resnet18"), ())] + [
        ({"on_screen_prints": True, "deterministic": det}, ("unet", "resnet18"), ())
        for det in dets]

    def check(results: list) -> None:
        runs = {}
        shipped, *wave = [cli_finish(r) for r in results]
        print(f"[cli] python -m kurosiwo_torch --method unet --backbone resnet18: exit 0 in "
              f"{shipped['seconds']:.1f} s ({shipped['at_once']} at once at most), Test Mean IOU "
              f"{shipped['miou']:.4f} [{smi}]", flush=True)
        for det, run in zip(dets, wave):
            first = next(x for x in run["lines"] if x.get("Iteration") == 0)["Train Loss"]
            train = next(x for x in run["lines"] if "Train epoch time (s)" in x)
            val = next(x for x in run["lines"] if "Val MeanIoU" in x)
            banks = {k: v for d in (train, val) for k, v in d.items() if "time" not in k}
            runs.setdefault(det, []).append({"first": first, "banks": banks,
                                             "miou": run["miou"]})
            print(f"[c14] deterministic={str(det).lower()}: first-step loss {first}, train mIoU "
                  f"{train['Train MeanIoU']:.5f}, val mIoU {val['Val MeanIoU']:.5f}, test mIoU "
                  f"{run['miou']!r}, {run['seconds']:.1f} s ({run['at_once']} at once at most) "
                  f"[{smi}]", flush=True)
        for det, (a, b) in runs.items():
            same = a == b
            differing = sorted(k for k in a["banks"] if a["banks"][k] != b["banks"].get(k))
            print(f"[c14] deterministic={str(det).lower()}: the two runs "
                  f"{'agree in every printed metric' if same else 'differ'}; test mIoU band "
                  f"{abs(a['miou'] - b['miou']):.4f}, first-step loss band "
                  f"{abs(a['first'] - b['first']):.5f}, bank metrics differing {len(differing)} "
                  f"{differing[:4]} [{smi}]", flush=True)
        require(runs[True][0] == runs[True][1], "two deterministic CLI runs at one seed differ")

    return CliJob(specs, check)


def _legs(phase: dict) -> dict:
    return {k: {"batch": v["batch"], "patches_per_s": v["rate"], "ms_per_step": v["ms"],
                "peak_gib": v["peak_gib"], "pair_sums_per_step": v["pair_sums"],
                "busy_ms_per_step": v["busy_ms"],
                **({"short_attention_per_step": v["short_attention"]}
                   if "short_attention" in v else {}),
                **({"eval_patches_per_s": v["eval_rate"]} if "eval_rate" in v else {})}
            for k, v in phase.items() if isinstance(v, dict) and "rate" in v}


def cd_summary(cd: dict | None, smi: str, attn: dict | None = None) -> str:
    """One line of the change-detection phases' numbers, printed near the
    end of the output so that they stay in its tail."""
    line = {"card": smi}
    if cd is not None:
        line.update(legs=_legs(cd), hfa_bf16_over_f32_first_layer_grad=cd["hfa_bf16_ratio"],
                    pair_sums_cd_shapes=cd["pair_sums_check"])
    if attn is not None:
        line["attention"] = {
            "legs": _legs(attn), "changeformer_eval": attn["changeformer eval"],
            "changeformer_no_memory_keys": (
                "out of memory" if attn["changeformer no memory keys"].get("oom")
                else _legs({"x": attn["changeformer no memory keys"]})["x"]),
            "memory_keys_peak_gib_b16_f32": attn["memory_keys"],
            "b4_a6": attn["b4"], "pair_sums_a6_shapes": attn["pair_sums_check"],
            "card_vs_cpu_launches": attn["parity"], "phase_wall_s": attn["wall_s"]}
    return "[cd summary] " + json.dumps(line)


def run_only(torch, counters, smi: str, only: set) -> None:
    """The phases of this slice alone (``--only``), for a short run while
    they are worked on."""
    from kurosiwo_torch import bench

    if only & {"engine", "feed"}:
        b = bench.setup(BATCH)
        seconds, _, _ = bench.run_train(b, 10, 3)
        del b
        torch.cuda.empty_cache()
        if "engine" in only:
            phase_engine(torch, counters, smi, 10 * BATCH / seconds)
        if "feed" in only:
            phase_packed_feed(torch, counters, smi, 10 * BATCH / seconds)
    if "augment" in only:
        phase_augment(torch, counters, smi)
    if "losses" in only:
        phase_losses_zones(torch, counters, smi)
    cli: list = []
    if "c14" in only:
        cli.append(c14_cli(smi))
    cd = phase_cd(torch, counters, smi, cli) if "cd" in only else None
    attn = phase_cd_attn(torch, counters, smi, cli) if "cd-attn" in only else None
    zoo = phase_seg_zoo(torch, counters, smi, cli) if "seg-zoo" in only else None
    mae = rec = diff = None
    if only & {"mae-train", "recurrent"}:
        from kurosiwo_torch.ops import fused_tail
        from kurosiwo_torch.ops import short_attention as sa

        mae = phase_mae_train(torch, counters, smi, sa, cli) if "mae-train" in only else None
        torch.cuda.empty_cache()
        rec = (phase_recurrent(torch, counters, smi, fused_tail, cli)
               if "recurrent" in only else None)
    if "diffusion" in only:
        torch.cuda.empty_cache()
        diff = phase_diffusion(torch, counters, smi, cli)
    weights = None
    if "weights" in only:
        b = bench.setup(BATCH)
        seconds, _, _ = bench.run_train(b, 10, 3)
        del b
        torch.cuda.empty_cache()
        weights = phase_weights(torch, counters, smi, cli, 10 * BATCH / seconds)
    if cli:
        phase_cli(torch, cli, smi)
    if cd is not None or attn is not None:
        print(cd_summary(cd, smi, attn), flush=True)
    if zoo is not None:
        print(zoo_summary(zoo, smi), flush=True)
    if mae is not None or rec is not None or diff is not None or weights is not None:
        print(slice_summary(mae, rec, smi, diff, weights), flush=True)


ONLY = {"engine", "feed", "augment", "losses", "c14", "cd", "cd-attn", "seg-zoo", "mae-train",
        "recurrent", "diffusion", "weights"}


def use_pycache() -> None:
    """Python's bytecode cache under the build directory, for this process
    and every process it starts (the CLI runs, the decode workers), where
    the repository holds the port: where the installation keeps no bytecode
    of its own, each process would otherwise compile torch's modules from
    source, about 9 s of a CLI run (NVIDIA H100 80GB HBM3 host, PERF.md)."""
    import os
    from pathlib import Path

    build = Path(__file__).resolve().parent / "kurosiwo_torch"
    if build.is_dir():
        prefix = str(build / "_build" / "pycache")
        sys.pycache_prefix = prefix
        os.environ["PYTHONPYCACHEPREFIX"] = prefix


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=None,
                        help=f"run only these phases of {sorted(ONLY)} (comma-separated) after "
                             "the device and build phases: a partial run, which prints no "
                             "kernel table and no result line")
    args = parser.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set()
    if only - ONLY:
        parser.error(f"unknown phases {sorted(only - ONLY)}")
    use_pycache()
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
    seconds: dict = {}

    def timed(phase, *args, **kw):
        start = time.perf_counter()
        try:
            return phase(*args, **kw)
        finally:
            seconds[phase.__name__] = seconds.get(phase.__name__, 0.0) + (
                time.perf_counter() - start)

    try:
        smi = phase_device(torch)
        phase_build(kernels)
        if only:
            run_only(torch, counters, smi, only)
            print(f"[done] partial run ({', '.join(sorted(only))}) in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            return 0
        pair = timed(phase_pair_sums, torch, batchnorm)
        ce = timed(phase_ce_cm, torch, fused_tail, "nhwc")
        phase = timed(phase_ce_cm, torch, fused_tail, "phase")
        print(f"[ce_cm phase] PHASE instantiation (no port path launches it yet): fwd "
              f"{phase['fwd']['ms']:.4f} ms, bwd {phase['bwd']['ms']:.4f} ms", flush=True)
        torch.cuda.empty_cache()
        attn = timed(phase_short_attention, torch, sa)
        flash = timed(phase_flash_attention, torch, fa)
        torch.cuda.empty_cache()
        cbn = timed(phase_conv_bn, torch, conv_bn)
        cdw = timed(phase_conv_dw, torch, conv_dw)
        cfu = timed(phase_conv_fused, torch, conv_fused)
        torch.cuda.empty_cache()
        timed(phase_parity, torch, counters)
        timed(phase_parity, torch, counters, routes=True)
        timed(phase_mae_parity, torch, counters)
        timed(phase_scene_parity, torch, fa)
        unet = timed(phase_main_path, torch, counters, smi)
        launches, routed = unet["train"], unet["train_routes"]
        torch.cuda.empty_cache()
        timed(phase_engine, torch, counters, smi, unet["train_rate"])
        torch.cuda.empty_cache()
        timed(phase_packed_feed, torch, counters, smi, unet["train_rate"])
        torch.cuda.empty_cache()
        timed(phase_augment, torch, counters, smi)
        timed(phase_losses_zones, torch, counters, smi)
        # every phase's CLI runs go to one pool, run after the last phase
        cli = [c14_cli(smi)]
        torch.cuda.empty_cache()
        cd = timed(phase_cd, torch, counters, smi, cli)
        torch.cuda.empty_cache()
        cd_attn = timed(phase_cd_attn, torch, counters, smi, cli)
        torch.cuda.empty_cache()
        zoo = timed(phase_seg_zoo, torch, counters, smi, cli)
        torch.cuda.empty_cache()
        mae_loop = timed(phase_mae_train, torch, counters, smi, sa, cli)
        torch.cuda.empty_cache()
        rec = timed(phase_recurrent, torch, counters, smi, fused_tail, cli)
        torch.cuda.empty_cache()
        diff = timed(phase_diffusion, torch, counters, smi, cli)
        torch.cuda.empty_cache()
        weights = timed(phase_weights, torch, counters, smi, cli, unet["train_rate"])
        torch.cuda.empty_cache()
        mae_launches = timed(phase_mae_main, torch, counters, smi)
        torch.cuda.empty_cache()
        scene_launches = timed(phase_scene_main, torch, counters, smi)
        timed(phase_cli, torch, cli, smi)
    except (PhaseFailed, RuntimeError, ValueError, TypeError, subprocess.SubprocessError,
            OSError) as e:
        print(f"[phases] seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}",
              flush=True)
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
        dict(row("pair_sums (per UNet train step: 30 fwd + 30 bwd calls; cd_launches_per_step: "
                 "the change-detection train steps, SNUNet with remat on and off; "
                 "cd_max_abs_err: against the plain version at their BatchNorm input shapes)",
                 "kurosiwo_torch/csrc/pair_sums.cu", "kurosiwo_tpu/ops/pallas_bn.py:48", pair,
                 launches["pair_sums"]),
             cd_launches_per_step={k: cd[k]["pair_sums"] for k in (
                 "snunet", "snunet_no_remat", "siam-diff", "hfa-net", "adhr-cdnet")},
             cd_shapes_checked=cd["pair_sums_check"]["shapes"],
             cd_max_abs_err=cd["pair_sums_check"]["max_abs_err"],
             cd_attn_launches_per_step={k: cd_attn[k]["pair_sums"] for k in (
                 "bit-cd", "bit-cd dd8", "changeformer", "transunet-cd")},
             cd_attn_shapes_checked=cd_attn["pair_sums_check"]["shapes"],
             cd_attn_max_abs_err=cd_attn["pair_sums_check"]["max_abs_err"],
             zoo_launches_per_step={k: zoo[k]["pair_sums"] for k, *_ in ZOO_LEGS},
             zoo_batch={k: zoo[k]["batch"] for k, *_ in ZOO_LEGS},
             zoo_shapes_checked=zoo["pair_sums_check"]["shapes"],
             zoo_max_abs_err=zoo["pair_sums_check"]["max_abs_err"],
             weights_launches=weights["encoder"]["launches"]["pair_sums"]),
        dict(row("ce_cm_fwd_nhwc (recurrent_*: the ConvLSTM step with fused_tail true, its "
                 "f32 probabilities)", "kurosiwo_torch/csrc/ce_cm.cu",
                 "kurosiwo_tpu/ops/pallas_tail.py:128", ce["fwd"], launches["ce_cm_fwd_nhwc"]),
             recurrent_launches_per_step=rec["fused_tail"]["ce_cm_fwd_nhwc"],
             recurrent_shape=rec["b2"]["shape"], recurrent_f32=rec["b2"]["fwd"],
             weights_launches=weights["encoder"]["launches"]["ce_cm_fwd_nhwc"],
             weights_parity_launches=weights["parity"]["launches"]["ce_cm_fwd_nhwc"]),
        dict(row("ce_cm_bwd_nhwc", "kurosiwo_torch/csrc/ce_cm.cu",
                 "kurosiwo_tpu/ops/pallas_tail.py:167", ce["bwd"], launches["ce_cm_bwd_nhwc"]),
             recurrent_launches_per_step=rec["fused_tail"]["ce_cm_bwd_nhwc"],
             recurrent_shape=rec["b2"]["shape"], recurrent_f32=rec["b2"]["bwd"],
             weights_launches=weights["encoder"]["launches"]["ce_cm_bwd_nhwc"]),
        dict(row("short_attention_fwd (the wgmma kernel; per MAE train step: 24 encoder + 8 "
                 "decoder calls)", "kurosiwo_torch/csrc/short_attention.cu",
                 "kurosiwo_tpu/ops/pallas_attention.py:259", attn["fwd"],
                 mae_launches["short_attention_fwd"]),
             mma_sync_ms=attn["fwd"]["mma_sync_ms"],
             mma_sync_max_abs_err=attn["fwd"]["mma_sync_err"],
             a6_launches_per_step={k: cd_attn[k]["short_attention"] for k in (
                 "bit-cd dd8", "changeformer")},
             a6_shapes_checked=cd_attn["b4"]["shapes"],
             a6_max_abs_err=cd_attn["b4"]["max_abs_err"]["fwd"],
             a6_bf16={k: dict(v["fwd"], kernel=v["kernel"], calls_per_step=v["calls_per_step"])
                      for k, v in cd_attn["b4"]["per_shape"].items()},
             finetune_launches_per_step=zoo["finetune ViT-L"]["short_attention"],
             finetune_max_abs_err=zoo["b4"]["max_abs_err"]["fwd"],
             finetune_bf16={k: dict(v["fwd"], kernel=v["kernel"],
                                    calls_per_step=v["calls_per_step"])
                            for k, v in zoo["b4"]["per_shape"].items()},
             mae_loop_launches_per_step=mae_loop["main"]["short_attention"],
             mae_loop_max_abs_err=mae_loop["b4"]["max_abs_err"]["fwd"],
             mae_loop_bf16={k: dict(v["fwd"], kernel=v["kernel"],
                                    calls_per_step=v["calls_per_step"])
                            for k, v in mae_loop["b4"]["per_shape"].items()}),
        dict(row("short_attention_bwd (the wgmma kernel; per MAE train step: 24 encoder + 8 "
                 "decoder calls; step_backward_ms: as the step runs it, into the qkv gradient's "
                 "thirds; library_qkv_backward_ms: SDPA's from one qkv leaf, with the concat)",
                 "kurosiwo_torch/csrc/short_attention.cu",
                 "kurosiwo_tpu/ops/pallas_attention.py:283", attn["bwd"],
                 mae_launches["short_attention_bwd"]),
             step_backward_ms=attn["bwd"]["step_ms"],
             library_qkv_backward_ms=attn["bwd"]["library_qkv_ms"],
             mma_sync_backward_ms=attn["bwd"]["mma_sync_ms"],
             a6_shapes_checked=cd_attn["b4"]["shapes"],
             a6_max_abs_err=cd_attn["b4"]["max_abs_err"]["bwd"],
             a6_bf16={k: dict(v["bwd"], kernel=v["kernel"], calls_per_step=v["calls_per_step"])
                      for k, v in cd_attn["b4"]["per_shape"].items()},
             finetune_launches_per_step=zoo["finetune ViT-L"]["short_attention"],
             finetune_max_abs_err=zoo["b4"]["max_abs_err"]["bwd"],
             finetune_bf16={k: dict(v["bwd"], kernel=v["kernel"],
                                    calls_per_step=v["calls_per_step"])
                            for k, v in zoo["b4"]["per_shape"].items()},
             mae_loop_launches_per_step=mae_loop["main"]["short_attention"],
             mae_loop_max_abs_err=mae_loop["b4"]["max_abs_err"]["bwd"],
             mae_loop_bf16={k: dict(v["bwd"], kernel=v["kernel"],
                                    calls_per_step=v["calls_per_step"])
                            for k, v in mae_loop["b4"]["per_shape"].items()}),
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
    print(cd_summary(cd, smi, cd_attn), flush=True)
    print(zoo_summary(zoo, smi), flush=True)
    print(slice_summary(mae_loop, rec, smi, diff, weights), flush=True)
    print(f"[phases] seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}",
          flush=True)
    print(f"[done] {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
