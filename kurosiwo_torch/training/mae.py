"""MAE (FloodViT) pretraining step; counterpart of
``kurosiwo_tpu/training/mae.py::make_mae_train_step``.

The epoch loop of the JAX ``train()`` (SSLLoader, schedule, checkpoints) is
not ported yet (ROADMAP.md, A4/A8); ``ops/schedules.mae_warmup_cosine`` gives
its learning rate.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.optim import set_learning_rate
from .state import TrainState


def make_mae_train_step(model: torch.nn.Module, accum: int = 1,
                        device: str | torch.device | None = "cuda"):
    """Returns ``train_step(state, batch, lr, generator, noise=None) ->
    (state, loss)``.

    ``batch["image"]`` (B, H, W, C) is cut into ``accum`` microbatches of
    B // accum images. Each draws its (B // accum, N) masking noise from
    ``generator`` (a ``torch.Generator`` on the step's device), unless the
    caller passes ``noise`` of shape (accum, B // accum, N). Gradients
    accumulate in f32 over the microbatches and are divided by ``accum``
    (with accum == 1 there is no accumulation and no division); the
    optimizer takes them in its moment dtype (bf16 for the MAE default, see
    ``ops/optim.AdamBF16Moments``). The loss is the mean over microbatches,
    a device tensor: nothing inside the step reads back to the host.
    """
    dev = resolve_device(device)
    num_patches = model.encoder.num_patches

    def train_step(state: TrainState, batch: dict, lr: float,
                   generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        images = torch.as_tensor(batch["image"]).to(dev, non_blocking=True)
        micro = images.shape[0] // accum
        model.train()
        set_learning_rate(state.optimizer, lr)
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = None
        for i in range(accum):
            if noise is None:
                mask_noise = torch.rand((micro, num_patches), generator=generator, device=dev)
            else:
                mask_noise = torch.as_tensor(noise[i]).to(dev)
            loss = model(images[i * micro:(i + 1) * micro], mask_noise)
            loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        if accum > 1:
            torch._foreach_div_([p.grad for p in model.parameters() if p.grad is not None],
                                float(accum))
        state.optimizer.step()
        state.step += 1
        return state, loss_sum / accum

    return train_step
