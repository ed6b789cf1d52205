"""Throughput benchmark of the port's train steps and whole-scene encode on the
card: ONE JSON line on stdout, ``{"metric", "value", "unit", "device"}``.

``--model unet`` (default): the UNet leg of the repository's ``bench.py``:
224x224 SAR patches, 6 input channels (post, pre1, pre2 in VV and VH), 3
classes, RandomEvents-weighted cross entropy, Adam, bf16 compute on f32
parameters, the same synthetic batch from ``numpy.random.RandomState(0)``.
``--eval`` measures the no-grad eval step, ``--eval --f32_eval`` its f32
twin (TF32 off). ``--set conv_bn_kernel=true --set dw_kernel=true`` turns on
the conv kernel routes of the train step (B6, B7); the JSON line names the
routes that were on.

``--model mae``: the MAE leg (``bench.py:197-252``): FloodViT MAE
pretraining, ViT-L encoder (dim 1024, depth 24, 16 heads, mlp 2048) on
224x224x6 images in 16x16 patches, decoder 512 x 8 layers, mask ratio 0.75,
batch 64, bf16 compute on f32 parameters, Adam with bf16 moments and lr
1e-4, accum 1; synthetic images from ``RandomState(0)``, masking noise from
a generator seeded once.

``--model scene``: the whole-scene leg (``scripts/bench_scene.py``): the
ViT-L encoder (dim 1024, depth 24, 16 heads of 64, mlp 2048, 6 channels,
bf16 compute on f32 parameters, seed 0) over one ``--scene``-sized square
scene from ``RandomState(0)`` as ONE attention sequence (4,096 tokens at
1024x1024, the flash attention kernel in all 24 layers). The headline is
the device-resident encode (the scene already on the card in bf16):
median, min and max scenes/s over 7 runs of 8 encodes, beside the median
of 3 runs of the upload-per-call path
(``vit_whole_scene`` from a host scene). The TPU script's control-matmul
bracket, a guard against the drift of a remotely attached TPU, is left out.

Usage: python -m kurosiwo_torch.bench [--model unet|mae|scene] [--batch N]
       [--steps 30] [--warmup 5] [--eval [--f32_eval]] [--set KEY=JSONVAL ...]
       [--scene 1024] [--profile]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .device import resolve_device
from .inference import encode_scene, pad_scene, vit_whole_scene
from .models.factory import build_mae, initialize_segmentation_model
from .models.vit import ViT
from .ops.losses import create_loss
from .ops.metrics import MetricState
from .training.mae import make_mae_train_step
from .training.state import TrainState, create_train_state
from .training.steps import make_eval_step, make_train_step

IMAGE = 224


def build_config(model: str, batch: int) -> dict:
    """The benchmark config of a segmentation model, as the repository's
    ``bench.build_config`` (the change-detection models are not ported)."""
    return {
        "task": "segmentation",
        "method": model,
        "num_classes": 3,
        "mixed_precision": True,
        "batch_size": batch,
        "weighted": True,
        "track": "RandomEvents",
        "class_weights": [0.3715753140309927, 14.009780283125977, 8.20405370357821],
        "loss_function": "cross_entropy",
        "inputs": ["pre_event_1", "pre_event_2", "post_event"],
        "channels": ["vv", "vh"],
        "dem": False,
        "log_zone_metrics": False,
        "log_AOI_metrics": False,
        "num_channels": 6,
    }


MODEL_CONFIG = {"backbone": "resnet18", "learning_rate": 1e-3, "optimizer": "adam"}
# the UNet's opt-in conv kernel routes (B6, B7), off unless --set turns them on
ROUTE_KEYS = ("conv_bn_kernel", "dw_kernel")

# the MAE leg of the repository's bench.py (bench_mae)
MAE_CONFIG = {"task": "mae", "num_channels": 6, "mixed_precision": True}
MAE_MODEL_CONFIG = {"image_size": 224, "patch_size": 16, "dim": 1024, "depth": 24, "heads": 16,
                    "mlp_dim": 2048, "decoder_dim": 512, "decoder_depth": 8,
                    "decoder_heads": 16, "masked_ratio": 0.75}
MAE_LR = 1e-4
MAE_MASK_SEED = 0


# the whole-scene leg (scripts/bench_scene.py): ViT-L encoder, bf16 compute
SCENE_VIT = {"image_size": 224, "patch_size": 16, "dim": 1024, "depth": 24, "heads": 16,
             "mlp_dim": 2048, "channels": 6}
SCENE_REPEATS, SCENE_INNER = 7, 8  # timed runs, encodes per run (bench_scene.py's defaults)


def host_batch(batch: int, size: int = IMAGE, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    return {
        "post": rs.randn(batch, size, size, 2).astype(np.float32),
        "pre1": rs.randn(batch, size, size, 2).astype(np.float32),
        "pre2": rs.randn(batch, size, size, 2).astype(np.float32),
        "mask": rs.randint(0, 4, (batch, size, size)).astype(np.int32),
        "sample_weight": np.ones((batch,), np.float32),
    }


@dataclasses.dataclass
class Bench:
    config: dict
    state: TrainState
    batch: dict
    device: torch.device
    generator: torch.Generator | None = None  # the MAE step's masking noise


def _backends() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True


def setup(batch: int | None = None, overrides: dict | None = None, device="cuda", seed: int = 0,
          model: str = "unet") -> Bench:
    """Model, train state and a device-resident batch for the UNet step
    (default batch 128, ``overrides`` update its config) or, with
    ``model="mae"``, the MAE step of ``setup_mae``."""
    if model == "mae":
        if overrides:
            raise ValueError("the MAE leg takes no config overrides")
        return setup_mae(batch, device, seed)
    if model != "unet":
        raise NotImplementedError(f"bench model {model!r} is not ported (unet, mae)")
    dev = resolve_device(device)
    _backends()
    batch = batch or 128
    cfg = build_config("unet", batch)
    cfg.update(overrides or {})
    net = initialize_segmentation_model(cfg, MODEL_CONFIG, device=dev, seed=seed)
    state = create_train_state(net, cfg, MODEL_CONFIG)
    data = {k: torch.from_numpy(v).to(dev) for k, v in host_batch(batch, seed=seed).items()}
    return Bench(cfg, state, data, dev)


def setup_mae(batch: int | None = None, device="cuda", seed: int = 0) -> Bench:
    """The MAE leg's model, train state, device-resident images (default
    batch 64) and masking-noise generator."""
    dev = resolve_device(device)
    _backends()
    batch = batch or 64
    size = MAE_MODEL_CONFIG["image_size"]
    net = build_mae(MAE_CONFIG, MAE_MODEL_CONFIG, device=dev, seed=seed)
    state = create_train_state(net, MAE_CONFIG, {"learning_rate": MAE_LR}, task="mae")
    images = np.random.RandomState(0).randn(batch, size, size, MAE_CONFIG["num_channels"])
    data = {"image": torch.from_numpy(images.astype(np.float32)).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(MAE_MASK_SEED)
    return Bench(dict(MAE_CONFIG), state, data, dev, gen)


@dataclasses.dataclass
class SceneBench:
    vit: ViT
    scene: np.ndarray  # (S, S, 6) f32, on the host
    dev_scene: torch.Tensor  # the same scene padded to whole patches, bf16 on the device
    device: torch.device


def setup_scene(size: int = 1024, device="cuda", seed: int = 0) -> SceneBench:
    """The scene leg's ViT-L encoder (random weights from ``seed``) and
    ``RandomState(0)`` scene, on the host and on the device."""
    dev = resolve_device(device)
    _backends()
    vit = ViT(**SCENE_VIT, pool="cls", dtype=torch.bfloat16,
              generator=torch.Generator().manual_seed(seed)).to(dev)
    scene = np.random.RandomState(0).randn(size, size, SCENE_VIT["channels"]).astype(np.float32)
    padded = pad_scene(scene, SCENE_VIT["patch_size"])[None]
    dev_scene = torch.from_numpy(np.ascontiguousarray(padded)).to(dev).to(torch.bfloat16)
    return SceneBench(vit, scene, dev_scene, dev)


def scene_fn(sb: SceneBench, upload: bool = False):
    """One encode per call: of the device-resident scene, or, with
    ``upload``, of the host scene through ``vit_whole_scene``."""
    if upload:
        return lambda: vit_whole_scene(sb.vit, sb.scene, device=sb.device)
    return lambda: encode_scene(sb.vit, sb.dev_scene)


def run_scene(sb: SceneBench, repeats: int, inner: int, upload: bool = False, warmup: int = 1):
    """Scenes/s of each of ``repeats`` runs of ``inner`` encodes (after
    ``warmup`` encodes), and the last output."""
    fn = scene_fn(sb, upload)
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize(sb.device)
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn()
        torch.cuda.synchronize(sb.device)
        rates.append(inner / (time.perf_counter() - t0))
    return rates, out


def _timed(fn, steps: int, warmup: int, device: torch.device):
    out = None
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def _train_fn(b: Bench):
    """One train step per call; returns the loss and keeps the metric bank."""
    step = make_train_step(b.state.model, create_loss(b.config, "train"), b.config,
                           MODEL_CONFIG, device=b.device)
    metric = [MetricState.create(b.device)]

    def one():
        _, metric[0], loss = step(b.state, b.batch, metric[0], 1e-3)
        return loss

    return one, metric


def _mae_train_fn(b: Bench):
    """One MAE train step per call; returns the loss."""
    step = make_mae_train_step(b.state.model, accum=1, device=b.device)

    def one():
        _, loss = step(b.state, b.batch, MAE_LR, b.generator)
        return loss

    return one


def _eval_fn(b: Bench, f32: bool):
    step = make_eval_step(b.state.model, create_loss(b.config, "val"), b.config, MODEL_CONFIG,
                          device=b.device, dtype=torch.float32 if f32 else None)
    metric = [MetricState.create(b.device)]

    def one():
        metric[0], loss, _ = step(b.state, b.batch, metric[0])
        return loss

    return one, metric


def run_train(b: Bench, steps: int, warmup: int):
    """Seconds for ``steps`` train steps after ``warmup``, the last loss (a
    device tensor) and the metric bank of all the steps."""
    one, metric = _train_fn(b)
    seconds, loss = _timed(one, steps, warmup, b.device)
    return seconds, loss, metric[0]


def run_mae_train(b: Bench, steps: int, warmup: int):
    """Seconds for ``steps`` MAE train steps after ``warmup`` and the last
    loss (a device tensor)."""
    return _timed(_mae_train_fn(b), steps, warmup, b.device)


def run_eval(b: Bench, steps: int, warmup: int, f32: bool = False):
    one, metric = _eval_fn(b, f32)
    seconds, loss = _timed(one, steps, warmup, b.device)
    return seconds, loss, metric[0]


_CATEGORIES = (  # kernel-name substrings -> what the time is spent on
    ("pair_sums kernel", ("pair_partials", "pair_finalize")),
    ("ce_cm kernel", ("ce_cm_", "ce_bwd")),
    ("short_attention kernel", ("attn_fwd", "attn_bwd", "short_fwd", "short_bwd")),
    ("flash_attention kernel", ("flash_fwd", "flash_dq", "flash_dkv")),
    ("conv kernels (B6, B7)", ("conv3x3", "conv_dw", "stats_fold", "dw_fold")),
    ("convolution / matmul (cuDNN, cuBLAS)", ("conv", "cudnn", "nvjet", "xmma", "gemm", "sm90_",
                                              "cutlass", "wgrad",
                             "dgrad", "fprop")),
    ("optimizer", ("adam", "multi_tensor")),
    ("reduction", ("reduce",)),
    ("elementwise / copy", ("elementwise", "copy", "fill", "cat", "index", "Memcpy", "Memset")),
)


def profile(fn, steps: int, device: torch.device, step_ms: float, file=sys.stderr) -> dict:
    """Device time by kernel over ``steps`` calls of ``fn`` (after the timed
    run, so the profiler's cost is not in the throughput), from
    torch.profiler; prints the top kernels, the shares by category and the
    device's busy share of ``step_ms``, the step time of the unprofiled run
    (the profiler slows the host, not the kernels). Returns {"wall_ms",
    "kernel_ms", "categories"}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernels only: an op's device time repeats its kernels', and
    # a record_function range (Optimizer.step#Adam.step) shows on the device
    # as an annotation spanning kernels that are listed themselves
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or e.key.startswith(("Optimizer.", "ProfilerStep")):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        kernels.append((t / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    total = sum(t for t, _, _ in kernels)
    cats: dict[str, float] = {}
    for t, _, name in kernels:
        low = name.lower()
        cat = next((c for c, keys in _CATEGORIES if any(k.lower() in low for k in keys)), "other")
        cats[cat] = cats.get(cat, 0.0) + t
    busy = total / steps
    print(f"[profile] {steps} steps: device busy {busy:.2f} ms/step, "
          f"{100 * busy / step_ms:.1f}% of the unprofiled {step_ms:.2f} ms/step "
          f"(idle {100 * max(0.0, 1 - busy / step_ms):.1f}%); profiled wall "
          f"{wall_ms / steps:.2f} ms/step", file=file)
    for cat, t in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {cat}: {t / steps:.3f} ms/step ({100 * t / total:.1f}%)", file=file)
    for t, n, name in kernels[:15]:
        print(f"[profile]   {t / steps:8.3f} ms/step  x{n / steps:g}/step  {name[:110]}", file=file)
    return {"wall_ms": wall_ms / steps, "kernel_ms": total / steps,
            "categories": {c: t / steps for c, t in cats.items()}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["unet", "mae", "scene"], default="unet")
    p.add_argument("--batch", type=int, default=None, help="default 128 for unet, 64 for mae")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--eval", action="store_true", help="time the no-grad eval step")
    p.add_argument("--f32_eval", action="store_true", help="with --eval: the f32 twin")
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSONVAL",
                   help="config override(s), e.g. --set fused_tail=false")
    p.add_argument("--scene", type=int, default=1024, help="scene leg: side in pixels")
    p.add_argument("--profile", action="store_true",
                   help="after the timed run, print device time by kernel to stderr")
    args = p.parse_args(argv)
    if args.model != "unet" and (args.eval or args.set):
        p.error(f"--eval, --set: the {args.model} leg has no eval step and takes no overrides")
    if args.model == "scene":
        return _main_scene(args)
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v
    if args.model == "mae":
        b = setup_mae(args.batch)
        batch = b.batch["image"].shape[0]
        one = _mae_train_fn(b)
        kind = "MAE pretrain step, ViT-L, bf16"
    else:
        b = setup(args.batch, overrides)
        batch = b.batch["mask"].shape[0]
        if args.eval:
            one, _ = _eval_fn(b, args.f32_eval)
            kind = f"eval fwd, unet, {'f32-twin' if args.f32_eval else 'bf16'}"
        else:
            one, _ = _train_fn(b)
            kind = "train fwd+bwd, unet, bf16"
    seconds, loss = _timed(one, args.steps, args.warmup, b.device)
    if not torch.isfinite(loss).item():
        raise RuntimeError(f"non-finite loss {loss.item()}")
    result = {
        "metric": f"224x224 SAR patches/sec ({kind}, batch {batch})",
        "value": args.steps * batch / seconds,
        "unit": "patches/sec",
        "device": torch.cuda.get_device_name(b.device),
    }
    if args.model == "unet":
        result["routes"] = {k: bool(b.config.get(k, False)) for k in ROUTE_KEYS}
    if args.profile:
        profile(one, min(args.steps, 5), b.device, seconds / args.steps * 1e3)
    print(json.dumps(result), flush=True)
    return result


def _main_scene(args) -> dict:
    sb = setup_scene(args.scene)
    upload, _ = run_scene(sb, SCENE_REPEATS // 2, SCENE_INNER, upload=True)
    rates, out = run_scene(sb, SCENE_REPEATS, SCENE_INNER)
    if not torch.isfinite(out).all().item():
        raise RuntimeError("non-finite scene features")
    median = float(np.median(rates))
    result = {
        "metric": f"whole-scene ViT-L encode, {args.scene}x{args.scene}",
        "value": median,
        "unit": "scenes/sec",
        "scenes_per_sec_median": median,
        "scenes_per_sec_min": float(min(rates)),
        "scenes_per_sec_max": float(max(rates)),
        "scenes_per_sec_upload_median": float(np.median(upload)),
        "repeats": SCENE_REPEATS,
        "device": torch.cuda.get_device_name(sb.device),
    }
    if args.profile:
        profile(scene_fn(sb), 5, sb.device, 1e3 / median)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
