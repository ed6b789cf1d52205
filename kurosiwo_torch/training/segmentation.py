"""Semantic-segmentation task frontend; counterpart of
``kurosiwo_tpu/training/segmentation.py`` (reference:
training/segmentation_trainer.py). The epoch loop, metric banks and
best-val-mIoU checkpointing live in ``engine.py``; these functions keep the
reference's signatures and return convention: eval returns (100·acc,
100·meanF1, 100·mIoU). ``seed`` seeds the engine's augmentation stream (the
port's weights come from the model factory's seed).
"""

from __future__ import annotations

from .engine import TaskEngine, train_task


def train_semantic_segmentation(model, train_loader, val_loader, test_loader, configs,
                                model_configs, seed=999, device="cuda", plan=None):
    return train_task(model, train_loader, val_loader, test_loader, configs, model_configs,
                      "segmentation", device=device, seed=seed, plan=plan)


def eval_semantic_segmentation(engine: TaskEngine, loader, settype="Test", configs=None,
                               model_configs=None):
    acc, f1, miou, _ = engine.run_eval(loader, settype)
    return acc, f1, miou
