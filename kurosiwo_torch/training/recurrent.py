"""Recurrent (ConvLSTM N-to-1) segmentation task front end; counterpart of
``kurosiwo_tpu/training/recurrent.py`` (the reference's
``training/recurrent_trainer.py``). The frames are stacked to (B, T=3, H, W,
C) in the order (pre2, pre1, post) by ``steps.assemble_recurrent_input``.
"""

from __future__ import annotations

from .engine import TaskEngine, train_task


def train_recurrent_segmentation(model, train_loader, val_loader, test_loader, configs,
                                 model_configs, seed=999, device="cuda", plan=None) -> TaskEngine:
    return train_task(model, train_loader, val_loader, test_loader, configs, model_configs,
                      "recurrent", device=device, seed=seed, plan=plan)


def eval_recurrent_segmentation(engine: TaskEngine, loader, checkpoint_dir=None,
                                settype="Test", configs=None, model_configs=None):
    acc, f1, miou, _ = engine.run_eval(loader, settype)
    return acc, f1, miou
