"""The port's command line; counterpart of the repository's ``main.py`` for
every task it dispatches (segmentation with the recurrent ConvLSTM, change
detection, MAE and diffusion pretraining): the same flags, plus
``--device`` (default ``cuda``).

    python -m kurosiwo_torch --method unet --backbone resnet18 [--seed 999]
        [--batch_size N] [--inputs ...] [--dem [--slope]]
        [--config_root configs] [--device cuda|cpu]
    python -m kurosiwo_torch --method unet++ [--backbone resnet18|resnet34|resnet50|resnet101]
        # or unetplusplus, deeplabv3 (the same backbones); upernet
        # [--backbone convnext_tiny|convnext_small|convnext_base|swin_tiny|swin_small|swin_base];
        # finetune (FloodViT, its ViT and head from configs/method/finetune/finetune.json)
    python -m kurosiwo_torch --method convlstm
        # the recurrent task: three frames (pre2, pre1, post) of 2 channels
    python -m kurosiwo_torch --method snunet --inputs pre_event_1 post_event
        # with "task": "cd" in configs/config.json; or siam-diff, siam-conc,
        # hfa-net, adhr-cdnet
    python -m kurosiwo_torch --method mae
        # with "task": "mae" in configs/config.json: FloodViT pretraining
    python -m kurosiwo_torch --method diffusion
        # DDPM pretraining on single 2-channel observations (diffusion.json)

For segmentation, recurrent segmentation and change detection it builds
the config, the loaders and the model, trains for ``epochs`` with a val
eval each epoch, keeps ``best_segmentation`` and ``latest`` (and, for
change detection and the recurrent task, ``checkpoint_epoch={e}`` every
``train_save_checkpoint_freq`` epochs), reloads best and prints ``Test Mean
IOU:``. ``"test": true`` in the config evaluates the saved best checkpoint
without training. Checkpoints land under ``checkpoints/`` in the working
directory. Without the Kuro Siwo corpus under ``root_path`` the loaders use
the synthetic source.

The task is the config's ``task``, as in ``main.py``: a change-detection
method runs with ``"task": "cd"`` in configs/config.json and two inputs
(``--inputs pre_event_1 post_event``); the CLI refuses a change-detection
method under another task, and a ``cd`` task with another number of inputs,
and says what to set. ``--method convlstm`` runs under ``"task":
"segmentation"``, as ``main.py`` dispatches it. ``"task": "mae"`` runs
``training/mae.train`` on the SSL loader (the method config's ViT and
schedule, ``batch_size`` from the train config or ``--batch_size``), with
``mae_{e}`` and ``vit_{e}`` in the checkpoint directory; ``main.py`` builds
the labelled loaders before it dispatches and the MAE branch never reads
them, so the port does not build them. ``--method diffusion`` (its method
config sets ``"task": "diffusion-unsup"``) runs ``training/diffusion.train``
on the per-observation loader, with ``diffusion_{e}`` in
``checkpoints/diffusion-unsup/``.

Data parallelism over N processes, as ``main.py`` runs over JAX's
processes: ``python -m torch.distributed.run --standalone --nproc_per_node N
-m kurosiwo_torch --method unet --backbone resnet18``. Each rank joins the
process group first (``parallel/distributed.initialize``; rank 0 prints
``Distributed runtime: process 0/N``), runs on ``cuda:LOCAL_RANK`` (the CPU
with ``--device cpu``), decodes its row block of every global batch of
``batch_size`` and steps on the global batch's loss and statistics
(``training/steps.py``); every rank prints the same metrics and ``Test Mean
IOU:``, rank 0 alone the config and the checkpoints it writes.
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
from .device import configure_backends
from .models.factory import (CD_METHODS, initialize_cd_model, initialize_recurrent_model,
                             initialize_segmentation_model)
from .parallel import create_mesh, initialize
from .parallel.distributed import rank_device, shutdown

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


def main(argv=None) -> float | None:
    """Run the CLI; returns the test mIoU (None for MAE and diffusion
    pretraining)."""
    args = build_parser().parse_args(argv)
    # the process group first, as main.py:45-51: a no-op for one process
    pi, pc = initialize(device=args.device)
    try:
        return _run(args, pi, pc)
    finally:
        shutdown()


def _run(args, pi: int, pc: int) -> float | None:
    if pc > 1 and pi == 0:
        print(f"Distributed runtime: process {pi}/{pc}", flush=True)
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)
    plan = create_mesh()
    device = rank_device(args.device) if plan.distributed else args.device
    show = pprint.pprint if pi == 0 else (lambda _: None)

    configs = load_config(method=args.method, backbone=args.backbone,
                          config_root=args.config_root, args=args)
    model_configs = configs["model_config"]
    task, method = configs["task"], configs["method"].lower()
    if task not in ("segmentation", "cd", "mae", "diffusion-unsup"):
        raise SystemExit(f"unknown task {task!r}")
    if task != "cd" and method in CD_METHODS:
        raise ValueError(f"{method!r} is a change-detection method and the config's task is "
                         f"{task!r}: set \"task\": \"cd\" in {args.config_root}/config.json "
                         "and pass --inputs pre_event_1 post_event")
    if task == "cd" and method in CD_METHODS and len(configs["inputs"]) != 2:
        raise ValueError(f"change detection requires exactly 2 inputs, got {configs['inputs']}: "
                         "pass --inputs pre_event_1 post_event")
    if args.batch_size is not None:
        configs["batch_size"] = int(args.batch_size)
    configure_backends(configs, device)  # before CUDA's first use (cuBLAS's workspace)
    if task == "diffusion-unsup":
        # main.py:63-70: no val/test splits; the trainer builds its own loader
        from .training import diffusion

        configs["checkpoint_path"] = create_checkpoint_directory(configs, model_configs)
        show({k: v for k, v in configs.items() if k != "model_config"})
        diffusion.train(configs, model_configs=model_configs, seed=args.seed, device=device,
                        plan=plan)
        return None
    if task == "mae":
        from .training import mae

        configs["checkpoint_path"] = create_checkpoint_directory(configs, model_configs)
        show({k: v for k, v in configs.items() if k != "model_config"})
        if pi == 0:
            print("Initializing Self-Supervised learning training with configs:", flush=True)
        mae.train(configs, seed=args.seed, model_configs=model_configs, device=device, plan=plan)
        return None
    recurrent = task == "segmentation" and method == "convlstm"
    # the model first: a method that is not ported raises before any directory is made
    if task == "cd":
        model = initialize_cd_model(configs, model_configs, "train", device=device,
                                    seed=args.seed)
    elif recurrent:
        model = initialize_recurrent_model(configs, model_configs, "train", device=device,
                                           seed=args.seed)
    else:
        model = initialize_segmentation_model(configs, model_configs, device=device,
                                              seed=args.seed)
    configs["checkpoint_path"] = create_checkpoint_directory(configs, model_configs)
    show({k: v for k, v in configs.items() if k != "model_config"})

    from .training.change_detection import eval_change_detection, train_change_detection
    from .training.engine import evaluate_task
    from .training.recurrent import eval_recurrent_segmentation, train_recurrent_segmentation
    from .training.segmentation import eval_semantic_segmentation, train_semantic_segmentation

    train_loader, val_loader, test_loader = prepare_loaders(configs, seed=args.seed)
    if pi == 0:
        print("Samples in Train Set: ", train_loader.num_samples())
        print("Samples in Val Set: ", val_loader.num_samples())
        print("Samples in Test Set: ", test_loader.num_samples())

    engine_task = "recurrent" if recurrent else task
    train_fn, eval_fn = {
        "cd": (train_change_detection, eval_change_detection),
        "recurrent": (train_recurrent_segmentation, eval_recurrent_segmentation),
        "segmentation": (train_semantic_segmentation, eval_semantic_segmentation),
    }[engine_task]
    if configs.get("test"):
        # eval-only (reference main.py:86-128): training would overwrite the
        # very best_segmentation the user asked to score
        engine = evaluate_task(model, configs, model_configs, engine_task, device=device,
                               seed=args.seed, plan=plan)
    else:
        engine = train_fn(model, train_loader, val_loader, test_loader, configs, model_configs,
                          seed=args.seed, device=device, plan=plan)
    _, _, miou = eval_fn(engine, test_loader, settype="Test")
    print("Test Mean IOU: ", miou, flush=True)
    return miou


if __name__ == "__main__":
    main(sys.argv[1:])
