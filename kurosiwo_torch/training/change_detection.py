"""Change-detection task frontend; counterpart of
``kurosiwo_tpu/training/change_detection.py`` (reference:
training/change_detection_trainer.py). The two-frame input assembly and the
dropout draws live in ``steps.py``, the forced-SGD optimizer choice for
bit-cd and hfa-net in ``ops/optim.py``, the per-epoch checkpoints and the
best-val save in ``engine.py``. Eval returns (100·acc, 100·meanF1,
100·mIoU), as the reference's.
"""

from __future__ import annotations

from .engine import TaskEngine, train_task


def train_change_detection(model, train_loader, val_loader, test_loader, configs,
                           model_configs, seed=999, device="cuda", plan=None):
    if len(configs["inputs"]) != 2:
        raise ValueError(f"change detection requires exactly 2 inputs, got {configs['inputs']}")
    return train_task(model, train_loader, val_loader, test_loader, configs, model_configs, "cd",
                      device=device, seed=seed, plan=plan)


def eval_change_detection(engine: TaskEngine, loader, settype="Test", configs=None,
                          model_configs=None):
    acc, f1, miou, _ = engine.run_eval(loader, settype)
    return acc, f1, miou
