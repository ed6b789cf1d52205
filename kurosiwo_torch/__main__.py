"""The port's command line; counterpart of the repository's ``main.py`` for
the segmentation task: the same flags, plus ``--device`` (default ``cuda``).

    python -m kurosiwo_torch --method unet --backbone resnet18 [--seed 999]
        [--batch_size N] [--inputs ...] [--dem [--slope]]
        [--config_root configs] [--device cuda|cpu]

It builds the config, the loaders and the model, trains for ``epochs`` with
a val eval each epoch, keeps ``best_segmentation`` and ``latest``, reloads
best and prints ``Test Mean IOU:``. ``"test": true`` in the config evaluates
the saved best checkpoint without training. Checkpoints land under
``checkpoints/`` in the working directory. Without the Kuro Siwo corpus
under ``root_path`` the loaders use the synthetic source.
"""

from __future__ import annotations

import argparse
import pprint
import random
import sys

import numpy as np
import torch

from .config import create_checkpoint_directory, load_config
from .data.pipeline import prepare_loaders
from .models.factory import initialize_segmentation_model

# the tasks main.py dispatches that the port does not run yet
_NOT_PORTED = {"cd": "A6", "mae": "A8", "diffusion-unsup": "A10"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m kurosiwo_torch")
    parser.add_argument("--method", default=None)
    parser.add_argument("--backbone", default=None)
    parser.add_argument("--dem", action="store_true", default=False)
    parser.add_argument("--slope", action="store_true", default=False)
    parser.add_argument("--batch_size", default=None)
    parser.add_argument("--inputs", nargs="+", default=None)
    parser.add_argument("--seed", type=int, default=999)
    parser.add_argument("--config_root", default="configs")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> float:
    """Run the CLI; returns the test mIoU."""
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)

    configs = load_config(method=args.method, backbone=args.backbone,
                          config_root=args.config_root, args=args)
    model_configs = configs["model_config"]
    task = configs["task"]
    if task in _NOT_PORTED:
        raise NotImplementedError(f"task {task!r} is not ported yet "
                                  f"(ROADMAP.md, {_NOT_PORTED[task]})")
    if task != "segmentation":
        raise SystemExit(f"unknown task {task!r}")
    if configs["method"] == "convlstm":
        raise NotImplementedError("the recurrent task (convlstm) is not ported yet "
                                  "(ROADMAP.md, A7)")
    if args.batch_size is not None:
        configs["batch_size"] = int(args.batch_size)
    configs["checkpoint_path"] = create_checkpoint_directory(configs, model_configs)
    pprint.pprint({k: v for k, v in configs.items() if k != "model_config"})

    from .training.engine import evaluate_task
    from .training.segmentation import eval_semantic_segmentation, train_semantic_segmentation

    train_loader, val_loader, test_loader = prepare_loaders(configs, seed=args.seed)
    print("Samples in Train Set: ", train_loader.num_samples())
    print("Samples in Val Set: ", val_loader.num_samples())
    print("Samples in Test Set: ", test_loader.num_samples())

    model = initialize_segmentation_model(configs, model_configs, device=args.device,
                                          seed=args.seed)
    if configs.get("test"):
        # eval-only (reference main.py:86-128): training would overwrite the
        # very best_segmentation the user asked to score
        engine = evaluate_task(model, configs, model_configs, "segmentation", device=args.device)
    else:
        engine = train_semantic_segmentation(model, train_loader, val_loader, test_loader,
                                             configs, model_configs, seed=args.seed,
                                             device=args.device)
    _, _, miou = eval_semantic_segmentation(engine, test_loader, settype="Test")
    print("Test Mean IOU: ", miou, flush=True)
    return miou


if __name__ == "__main__":
    main(sys.argv[1:])
