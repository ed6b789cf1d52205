"""The accuracy-parity harness; counterpart of ``kurosiwo_tpu/parity.py``.

One command takes a reference torch checkpoint, loads it through the
engine's own ``pretrained_checkpoint`` route (the method's converter,
``convert.CONVERTERS``), runs the whole test split's evaluation in f32 and
prints the per-class F1 and IoU, with their deltas against expected numbers
where given:

    python -m kurosiwo_torch.parity --checkpoint best_segmentation.pt \\
        --model snunet --root /data/kuro_siwo [--expected-f1 76.2] [--tolerance 0.5] \\
        [--device cuda|cpu]

It runs on the card unless ``--device cpu``. Without the corpus under
``--root`` the loaders use the synthetic source. A delta outside
``--tolerance`` exits with ``PARITY FAILED``. The reference's
``best_segmentation.pt`` is its whole pickled SNUNet module; ``floodvit.pt``
is an encoder without a segmentation head, so a finetuned ViT checkpoint is
evaluated here with ``--model finetune``.

The JAX harness sizes the finetuner's init by ``image_size`` (its
``init_size``); the port builds every model at its shapes when it
constructs it (``models/factory.py``: the finetuner from ``image_size``),
so there is nothing to size here.
"""

from __future__ import annotations

import argparse
import json

_CD = ("cd", {"inputs": ["pre_event_1", "post_event"]})
_MODEL_TASKS = {
    "snunet": _CD, "siam-diff": _CD, "siam-conc": _CD, "bit-cd": _CD, "changeformer": _CD,
    "hfa-net": _CD, "adhr-cdnet": _CD, "transunet-cd": _CD,
    "unet": ("segmentation", {}),
    "finetune": ("segmentation", {}),
    "convlstm": ("recurrent", {}),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m kurosiwo_torch.parity")
    p.add_argument("--checkpoint", required=True, help="torch checkpoint path")
    p.add_argument("--model", required=True, choices=sorted(_MODEL_TASKS))
    p.add_argument("--root", default=None,
                   help="Kuro Siwo data root (synthetic fallback if absent)")
    p.add_argument("--config_root", default="configs")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--expected-f1", type=float, default=None,
                   help="reference test mean F1 to compare against")
    p.add_argument("--expected-iou", type=float, default=None)
    p.add_argument("--tolerance", type=float, default=0.5,
                   help="max |delta| in points (BASELINE north star)")
    p.add_argument("--seed", type=int, default=999)
    p.add_argument("--override", default=None,
                   help="JSON dict merged into the config "
                        "(e.g. '{\"synthetic_size\": 8, \"dim\": 64}')")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def run(args) -> dict:
    """The report: the JAX harness's keys (checkpoint, model, test accuracy,
    mean F1 and mIoU, per-class F1 and IoU in points; the deltas and
    ``*_within_tolerance`` where expected numbers are given), plus the test
    confusion matrix ``test_confusion`` (true x predicted, ignore row and
    column last) that the scores derive from."""
    from .config import load_config
    from .data.pipeline import prepare_loaders
    from .device import configure_backends
    from .models.factory import (initialize_cd_model, initialize_recurrent_model,
                                 initialize_segmentation_model)
    from .training.engine import TaskEngine

    task, extra = _MODEL_TASKS[args.model]
    overrides = {"task": task, "batch_size": args.batch_size, **extra}
    if args.root:
        overrides["root_path"] = args.root
    if args.override:
        overrides.update(json.loads(args.override))
    configs = load_config(method=args.model, config_root=args.config_root, overrides=overrides)
    mcfg = configs["model_config"]
    # the f32 eval twin, as the reference evaluates with autocast off
    configs["mixed_precision"] = False
    configure_backends(configs, args.device)  # before CUDA's first use (cuBLAS's workspace)

    loaders = prepare_loaders(configs, seed=args.seed)
    try:
        init = {"cd": initialize_cd_model, "recurrent": initialize_recurrent_model}.get(
            task, initialize_segmentation_model)
        model = init(configs, mcfg, device=args.device, seed=args.seed)
        # through the engine's own pretrained_checkpoint route: the loader
        # production uses, no state swapped in by hand
        configs["pretrained_checkpoint"] = args.checkpoint
        engine = TaskEngine(model, configs, mcfg, task, steps_per_epoch=1, device=args.device,
                            seed=args.seed)
        acc, mean_f1, miou, summary = engine.run_eval(loaders[2], "Test")
    finally:
        for loader in loaders:
            loader.close()
    report = {
        "checkpoint": args.checkpoint,
        "model": args.model,
        "test_accuracy": acc,
        "test_mean_f1": mean_f1,
        "test_mean_iou": miou,
        "per_class_f1": [100.0 * float(v) for v in list(summary["fscore"])[:3]],
        "per_class_iou": [100.0 * float(v) for v in list(summary["iou"])[:3]],
        "test_confusion": [[int(x) for x in row] for row in summary["cm"]],
    }
    if args.expected_f1 is not None:
        report["delta_f1"] = mean_f1 - args.expected_f1
        report["f1_within_tolerance"] = abs(report["delta_f1"]) <= args.tolerance
    if args.expected_iou is not None:
        report["delta_iou"] = miou - args.expected_iou
        report["iou_within_tolerance"] = abs(report["delta_iou"]) <= args.tolerance
    return report


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    report = run(args)
    print(json.dumps(report, indent=2), flush=True)
    failed = [k for k in ("f1_within_tolerance", "iou_within_tolerance")
              if report.get(k) is False]
    if failed:
        raise SystemExit(f"PARITY FAILED: {failed}")
    return report


if __name__ == "__main__":
    main()
