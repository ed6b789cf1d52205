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

``--model snunet``: the SNUNet-ECAM leg (``bench.py:167-188``, ``:325-350``):
change detection on two 224x224 frames (``pre_event_1``, ``post_event``) of
2 channels each, base_channel 32, batch 128, bf16 compute on f32
parameters, RandomEvents-weighted cross entropy, Adam at lr 1e-3, remat on
(the factory's default at batch >= 64; ``--set remat=false`` turns it off);
``--eval [--f32_eval]`` as for the UNet. ``--model siam-diff`` (and
``siam-conc``, ``hfa-net``, ``adhr-cdnet``) runs that model on the same
config and code (the repository's ``bench.py`` has no such leg), Siam's
dropout masks drawn from a generator seeded once. ``--model bit-cd`` and
``--model changeformer`` are the repository's other two change-detection
legs, ``--model transunet-cd`` runs on the same config: the same model
config, so BiT-CD is its ``net_G`` default (``base_resnet18``) and
ChangeFormer runs with its defaults (embed_dim 256, ``tail_chunks`` and
``remat_ffn`` on "auto", its five heads scored on the last one).

``--model unet++`` (or ``unetplusplus``), ``deeplabv3``, ``upernet`` and
``finetune``: the rest of the segmentation zoo on the UNet leg's config
(the same batch, loss, Adam and bf16 policy) with the method swapped in
and its shipped model config (``configs/method/<method>/*.json``): UNet++
and DeepLabV3+ on resnet18, UperNet on convnext_tiny, each at lr 1e-3 as
the UNet leg; ``--set backbone=...`` picks another backbone (resnet34/50/101;
convnext_small/base, swin_tiny/small/base). ``finetune`` is the FloodViT
finetuner with ``finetune.json``'s ViT-L (dim 1024, depth 24, 16 heads,
mlp 2048, 16x16 patches of 224x224) and mlp head, at its lr 1e-4.

``--model convlstm``: the recurrent task's ConvLSTM on the UNet leg's config
with the method swapped in: the three frames (pre2, pre1, post) of 2
channels each at 224x224, batch 128, bf16 compute on f32 parameters,
RandomEvents-weighted cross entropy on the model's probabilities, plain
Adam at lr 1e-3 (the recurrent engine's optimizer); ``--eval [--f32_eval]``
as for the UNet (the repository's ``bench.py`` has no such leg).

``--model mae``: the MAE leg (``bench.py:197-252``): FloodViT MAE
pretraining, ViT-L encoder (dim 1024, depth 24, 16 heads, mlp 2048) on
224x224x6 images in 16x16 patches, decoder 512 x 8 layers, mask ratio 0.75,
batch 64, bf16 compute on f32 parameters, Adam with bf16 moments and lr
1e-4, accum 1; synthetic images from ``RandomState(0)``, masking noise from
a generator seeded once.

``--model diffusion``: the diffusion task's DDPM train step (the repository's
``bench.py`` has no such leg): ``configs/method/diffusion/diffusion.json``'s
UNet (dim 64, dim_mults (1, 2, 4, 8), 1000 timesteps, 2 channels) on
224x224x2 single observations from ``RandomState(0)``, batch 128, bf16
compute on f32 parameters, the L1 loss at uniform timesteps, Adam at lr
1e-4; timesteps and noise from a generator seeded once.

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

Every leg takes ``--set deterministic=true|false`` (deterministic algorithms
on the card, ``device.configure_backends``; on by default for the UNet,
change-detection and diffusion legs, off for the ViT legs); the other keys
set the UNet's or the change-detection leg's config.

Usage: python -m kurosiwo_torch.bench [--model unet|unet++|deeplabv3|upernet|finetune|snunet|
       siam-diff|...|convlstm|mae|diffusion|scene] [--batch N]
       [--steps 30] [--warmup 5] [--eval [--f32_eval]] [--set KEY=JSONVAL ...]
       [--scene 1024] [--profile]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time

import numpy as np
import torch

from .device import configure_backends, resolve_device
from .inference import encode_scene, pad_scene, vit_whole_scene
from .models.factory import (PORTED_CD_METHODS, build_mae, initialize_cd_model,
                             initialize_recurrent_model, initialize_segmentation_model)
from .models.vit import ViT
from .ops.losses import create_loss
from .ops.metrics import MetricState
from .training.diffusion import make_diffusion_train_step
from .training.mae import make_mae_train_step
from .training.state import TrainState, create_train_state
from .training.steps import make_eval_step, make_train_step

IMAGE = 224


# the change-detection legs: the repository's bench.py has snunet, bit-cd and
# changeformer; the port runs its other change-detection models on the same
# config
CD_MODELS = PORTED_CD_METHODS


# the recurrent task's models: one frame's channels a model input, the
# recurrent steps
RECURRENT_MODELS = ("convlstm",)


# the rest of the segmentation zoo: the shipped model config's keys that
# build each model (configs/method/<method>/*.json), and each leg's lr
ZOO_MODEL_CONFIGS = {"unet++": {"backbone": "resnet18"}, "unetplusplus": {"backbone": "resnet18"},
                     "deeplabv3": {"backbone": "resnet18"},
                     "upernet": {"backbone": "convnext_tiny"}, "finetune": {}}
ZOO_MODELS = tuple(ZOO_MODEL_CONFIGS)
# finetune.json's ViT-L and head, read by the factory from the config
FINETUNE_CONFIG = {"image_size": 224, "finetuning_patch_size": 16, "dim": 1024, "depth": 24,
                   "heads": 16, "mlp_dim": 2048, "mlp": True, "decoder": False}
FINETUNE_LR = 1e-4
TRAIN_LR = 1e-3
# the model-config key a --set may give a zoo leg
ZOO_MODEL_KEYS = ("backbone",)


def build_config(model: str, batch: int) -> dict:
    """The benchmark config of a model, as the repository's
    ``bench.build_config``: a change-detection model gets two 2-channel
    frames; the finetuner adds ``FINETUNE_CONFIG``."""
    cd = model in CD_MODELS
    per_frame = cd or model in RECURRENT_MODELS
    extra = FINETUNE_CONFIG if model == "finetune" else {}
    return {
        "task": "cd" if cd else "segmentation",
        "method": model,
        "num_classes": 3,
        "mixed_precision": True,
        "batch_size": batch,
        "weighted": True,
        "track": "RandomEvents",
        "class_weights": [0.3715753140309927, 14.009780283125977, 8.20405370357821],
        "loss_function": "cross_entropy",
        "inputs": (["pre_event_1", "post_event"] if cd
                   else ["pre_event_1", "pre_event_2", "post_event"]),
        "channels": ["vv", "vh"],
        "dem": False,
        "log_zone_metrics": False,
        "log_AOI_metrics": False,
        "num_channels": 2 if per_frame else 6,
        **extra,
    }


# the repository's bench.py model config, the same for every leg
MODEL_CONFIG = {"backbone": "resnet18", "learning_rate": 1e-3, "base_channel": 32,
                "optimizer": "adam"}
# the UNet's opt-in conv kernel routes (B6, B7), off unless --set turns them on
ROUTE_KEYS = ("conv_bn_kernel", "dw_kernel")

# the MAE leg of the repository's bench.py (bench_mae)
MAE_CONFIG = {"task": "mae", "num_channels": 6, "mixed_precision": True}
MAE_MODEL_CONFIG = {"image_size": 224, "patch_size": 16, "dim": 1024, "depth": 24, "heads": 16,
                    "mlp_dim": 2048, "decoder_dim": 512, "decoder_depth": 8,
                    "decoder_heads": 16, "masked_ratio": 0.75}
MAE_LR = 1e-4
MAE_MASK_SEED = 0


# the diffusion leg: configs/method/diffusion/diffusion.json's DDPM
DIFFUSION_CONFIG = {"task": "diffusion-unsup", "method": "diffusion", "mixed_precision": True}
DIFFUSION_MODEL_CONFIG = {"dim": 64, "dim_mults": [1, 2, 4, 8], "timesteps": 1000,
                          "learning_rate": 1e-4}


# the whole-scene leg (scripts/bench_scene.py): ViT-L encoder, bf16 compute
SCENE_VIT = {"image_size": 224, "patch_size": 16, "dim": 1024, "depth": 24, "heads": 16,
             "mlp_dim": 2048, "channels": 6}
SCENE_REPEATS, SCENE_INNER = 7, 8  # timed runs, encodes per run (bench_scene.py's defaults)


def host_batch(batch: int, size: int = IMAGE, seed: int = 0) -> dict:
    """The legs' synthetic batch from ``numpy.random.RandomState(seed)``, the
    caller's own copy of arrays drawn once per (batch, size, seed): a b128
    draw takes seconds of host time, and a process that sets up several
    legs draws it once."""
    return {k: v.copy() for k, v in _host_arrays(batch, size, seed).items()}


@functools.lru_cache(maxsize=4)
def _host_arrays(batch: int, size: int, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    return {
        "post": rs.randn(batch, size, size, 2).astype(np.float32),
        "pre1": rs.randn(batch, size, size, 2).astype(np.float32),
        "pre2": rs.randn(batch, size, size, 2).astype(np.float32),
        "mask": rs.randint(0, 4, (batch, size, size)).astype(np.int32),
        "valid": np.ones((batch, size, size), np.int32),
        "sample_weight": np.ones((batch,), np.float32),
        "clz": rs.randint(1, 4, (batch,)).astype(np.int32),
    }


@dataclasses.dataclass
class Bench:
    config: dict
    state: TrainState
    batch: dict
    device: torch.device
    # the MAE step's masking noise, the augmentations' and dropout masks' draws
    generator: torch.Generator | None = None
    model_config: dict = dataclasses.field(default_factory=lambda: dict(MODEL_CONFIG))
    lr: float = TRAIN_LR

    @property
    def task(self) -> str:
        """The steps' task: the config's, ``recurrent`` for the ConvLSTM."""
        if self.config.get("method") in RECURRENT_MODELS:
            return "recurrent"
        return self.config.get("task", "segmentation")


def setup(batch: int | None = None, overrides: dict | None = None, device="cuda", seed: int = 0,
          model: str = "unet", model_config: dict | None = None) -> Bench:
    """Model, train state and a device-resident batch for the UNet step, a
    zoo step (``ZOO_MODELS``: ``ZOO_MODEL_CONFIGS`` over ``MODEL_CONFIG``;
    ``backbone`` in ``overrides`` goes to the model config), a
    change-detection step (``CD_MODELS``) or the recurrent step
    (``RECURRENT_MODELS``); default batch 128, ``overrides`` update the
    config, ``model_config`` updates the model config; with
    ``model="mae"``, the MAE step of ``setup_mae``."""
    if model == "mae":
        if overrides:
            raise ValueError("the MAE leg takes no config overrides")
        return setup_mae(batch, device, seed)
    if model != "unet" and model not in CD_MODELS + ZOO_MODELS + RECURRENT_MODELS:
        raise NotImplementedError(f"bench model {model!r} is not ported (unet, "
                                  f"{', '.join(ZOO_MODELS + CD_MODELS + RECURRENT_MODELS)}, "
                                  "mae)")
    dev = resolve_device(device)
    batch = batch or 128
    cfg = build_config(model, batch)
    overrides = dict(overrides or {})
    mcfg = {**MODEL_CONFIG, **ZOO_MODEL_CONFIGS.get(model, {}),
            **{k: overrides.pop(k) for k in ZOO_MODEL_KEYS if k in overrides},
            **(model_config or {})}
    cfg.update(overrides)
    configure_backends(cfg, dev)
    if cfg["task"] == "cd":
        net = initialize_cd_model(cfg, mcfg, device=dev, seed=seed)
    elif model in RECURRENT_MODELS:
        net = initialize_recurrent_model(cfg, mcfg, device=dev, seed=seed)
    else:
        net = initialize_segmentation_model(cfg, mcfg, device=dev, seed=seed)
    state = create_train_state(net, cfg, mcfg, cfg["task"])  # the recurrent task: plain Adam
    data = {k: torch.from_numpy(v).to(dev) for k, v in host_batch(batch, seed=seed).items()}
    return Bench(cfg, state, data, dev, torch.Generator(dev).manual_seed(seed), mcfg,
                 FINETUNE_LR if model == "finetune" else TRAIN_LR)


def setup_mae(batch: int | None = None, device="cuda", seed: int = 0,
              backend: dict | None = None) -> Bench:
    """The MAE leg's model, train state, device-resident images (default
    batch 64) and masking-noise generator; ``backend`` holds the backend
    keys (``deterministic``) for ``configure_backends``."""
    dev = resolve_device(device)
    configure_backends({**MAE_CONFIG, **(backend or {})}, dev)
    batch = batch or 64
    size = MAE_MODEL_CONFIG["image_size"]
    net = build_mae(MAE_CONFIG, MAE_MODEL_CONFIG, device=dev, seed=seed)
    state = create_train_state(net, MAE_CONFIG, {"learning_rate": MAE_LR}, task="mae")
    images = np.random.RandomState(0).randn(batch, size, size, MAE_CONFIG["num_channels"])
    data = {"image": torch.from_numpy(images.astype(np.float32)).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(MAE_MASK_SEED)
    return Bench(dict(MAE_CONFIG), state, data, dev, gen)


def setup_diffusion(batch: int | None = None, device="cuda", seed: int = 0,
                    backend: dict | None = None, model_config: dict | None = None) -> Bench:
    """The diffusion leg's model (``DIFFUSION_MODEL_CONFIG`` updated by
    ``model_config``), train state, device-resident images (default batch
    128, 224x224x2) and the generator of its timesteps and noise;
    ``backend`` holds the backend keys (``deterministic``)."""
    dev = resolve_device(device)
    cfg = {**DIFFUSION_CONFIG, **(backend or {})}
    configure_backends(cfg, dev)
    mcfg = {**DIFFUSION_MODEL_CONFIG, **(model_config or {})}
    net = initialize_segmentation_model(cfg, mcfg, device=dev, seed=seed)
    state = create_train_state(net, cfg, mcfg, "segmentation")
    images = np.random.RandomState(0).randn(batch or 128, IMAGE, IMAGE, 2).astype(np.float32)
    return Bench(cfg, state, {"image": torch.from_numpy(images).to(dev)}, dev,
                 torch.Generator(device=dev).manual_seed(seed), mcfg, mcfg["learning_rate"])


def _diffusion_train_fn(b: Bench):
    """One diffusion train step per call; returns the loss."""
    step = make_diffusion_train_step(b.state.model, device=b.device)

    def one():
        _, loss = step(b.state, b.batch, b.generator)
        return loss

    return one


@dataclasses.dataclass
class SceneBench:
    vit: ViT
    scene: np.ndarray  # (S, S, 6) f32, on the host
    dev_scene: torch.Tensor  # the same scene padded to whole patches, bf16 on the device
    device: torch.device


def setup_scene(size: int = 1024, device="cuda", seed: int = 0,
                backend: dict | None = None) -> SceneBench:
    """The scene leg's ViT-L encoder (random weights from ``seed``) and
    ``RandomState(0)`` scene, on the host and on the device; ``backend`` as
    for ``setup_mae``."""
    dev = resolve_device(device)
    configure_backends(backend, dev)
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
                           b.model_config, task=b.task, device=b.device)
    metric = [MetricState.create(b.device)]

    def one():
        _, metric[0], loss = step(b.state, b.batch, metric[0], b.lr, b.generator)
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
    step = make_eval_step(b.state.model, create_loss(b.config, "val"), b.config,
                          b.model_config, task=b.task, device=b.device,
                          dtype=torch.float32 if f32 else None)
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
    "kernel_ms", "launches", "categories"}, a call's each (``launches``:
    its kernel launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize(device)
    # the card's activity alone: the host ops' events would only be dropped
    # below, and reading them back costs seconds a profile
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
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
            "launches": sum(n for _, n, _ in kernels) / steps,
            "categories": {c: t / steps for c, t in cats.items()}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["unet", *ZOO_MODELS, *CD_MODELS, *RECURRENT_MODELS,
                                       "mae", "diffusion", "scene"],
                   default="unet")
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
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v
    if args.model in ("mae", "diffusion", "scene") and (
            args.eval or set(overrides) - {"deterministic"}):
        p.error(f"--eval, --set: the {args.model} leg has no eval step and takes only "
                "--set deterministic=...")
    if args.model == "scene":
        return _main_scene(args, overrides)
    if args.model == "mae":
        b = setup_mae(args.batch, backend=overrides)
        batch = b.batch["image"].shape[0]
        one = _mae_train_fn(b)
        kind = "MAE pretrain step, ViT-L, bf16"
    elif args.model == "diffusion":
        b = setup_diffusion(args.batch, backend=overrides)
        batch = b.batch["image"].shape[0]
        one = _diffusion_train_fn(b)
        kind = "DDPM train step, dim 64, bf16"
    else:
        b = setup(args.batch, overrides, model=args.model)
        batch = b.batch["mask"].shape[0]
        if args.eval:
            one, _ = _eval_fn(b, args.f32_eval)
            kind = f"eval fwd, {args.model}, {'f32-twin' if args.f32_eval else 'bf16'}"
        else:
            one, _ = _train_fn(b)
            kind = f"train fwd+bwd, {args.model}, bf16"
    seconds, loss = _timed(one, args.steps, args.warmup, b.device)
    if not torch.isfinite(loss).item():
        raise RuntimeError(f"non-finite loss {loss.item()}")
    result = {
        "metric": f"224x224 SAR patches/sec ({kind}, batch {batch})",
        "value": args.steps * batch / seconds,
        "unit": "patches/sec",
        "device": torch.cuda.get_device_name(b.device),
    }
    if args.model in ZOO_MODELS:
        result["model_config"] = {k: b.model_config[k] for k in ZOO_MODEL_KEYS
                                  if k in b.model_config}
    if args.model == "unet":
        result["routes"] = {k: bool(b.config.get(k, False)) for k in ROUTE_KEYS}
    if b.task == "cd":  # SNUNet's plan is the model's, the others' the step's
        result["remat"] = bool(b.config.get("remat", getattr(b.state.model, "remat", False)))
    if args.profile:
        profile(one, min(args.steps, 5), b.device, seconds / args.steps * 1e3)
    print(json.dumps(result), flush=True)
    return result


def _main_scene(args, backend: dict) -> dict:
    sb = setup_scene(args.scene, backend=backend)
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
