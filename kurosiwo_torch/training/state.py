"""Train state; counterpart of ``kurosiwo_tpu/training/state.py``.

In the port the parameters and BatchNorm statistics live in the model
(an ``nn.Module``, f32 parameters) and the Adam moments in the optimizer;
the state bundles both with the step count. The bf16 policy is the model's
compute dtype, so no loss scaling is needed (bf16 has f32's exponent range).
``task="mae"`` gives the MAE optimizer (bf16 moments by default), ``task="cd"``
the change-detection choice (``ops/optim.create_cd_optimizer``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.optim import create_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer | None  # None: a model alone (MAE's vit_{e})


def create_train_state(model: torch.nn.Module, config: dict, model_config: dict,
                       task: str = "segmentation") -> TrainState:
    optimizer = create_optimizer(model.named_parameters(), config, model_config, task)
    return TrainState(step=0, model=model, optimizer=optimizer)
