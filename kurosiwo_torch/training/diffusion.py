"""Diffusion pretraining (task ``diffusion-unsup``); counterpart of
``kurosiwo_tpu/training/diffusion.py``: per-observation records (pre1, pre2
and flood as independent 2-channel images, ``data/pipeline.py``), the DDPM
loss step (``models/diffusion.GaussianDiffusion``) under the segmentation
task's Adam, and a checkpoint ``diffusion_{e}`` each epoch.

The step follows the MAE loop's pattern (``training/mae.py``): batches
reach the card through ``device_prefetch``, the compute is the model's
dtype (bf16 under ``mixed_precision``) on f32 parameters, and nothing in
the step reads back to the host; the loop reads the loss only where it
prints it. The timesteps and noise come from one ``torch.Generator`` on
the step's device, seeded from the seed; ``jax.random``'s stream is not
replayed, so a seed gives other draws than the JAX package's.

Under data parallelism (a ``MeshPlan``) each rank decodes its row block of
every global batch, draws the global batch's timesteps and noise and keeps
its rows (``models/diffusion.GaussianDiffusion``), and the gradients and
the loss are averaged over the data group: the loss is a mean over
equal-sized per-sample terms, so the mean of the ranks' means is the global
one.
"""

from __future__ import annotations

import torch

from ..data.pipeline import Loader
from ..device import configure_backends, resolve_device
from ..models.factory import initialize_segmentation_model
from ..parallel.mesh import MeshPlan, all_reduce_sum, broadcast_module, sync_gradients, use_grid
from .checkpoint import CheckpointManager
from .engine import device_prefetch
from .state import TrainState, create_train_state


def make_diffusion_train_step(model: torch.nn.Module,
                              device: str | torch.device | None = "cuda",
                              plan: MeshPlan | None = None):
    """Returns ``train_step(state, batch, generator, t=None, noise=None) ->
    (state, loss)``: the DDPM loss of ``batch["image"]`` (B, H, W, 2) at
    timesteps ``t`` with ``noise`` (drawn from ``generator`` where None),
    its backward and one optimizer update. The loss is a device tensor.
    With ``plan`` the step is data parallel (see the module docstring)."""
    dev = resolve_device(device)
    grid = plan.data_grid() if plan is not None else None

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None,
                   t: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        images = torch.as_tensor(batch["image"]).to(dev, non_blocking=True)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with use_grid(grid):
            loss = model(images, t=t, noise=noise, generator=generator)
        loss.backward()
        sync_gradients(model.parameters(), grid, average=True)
        state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        if grid is not None:
            loss = all_reduce_sum(loss, grid) / grid.count
        return state, loss

    return train_step


def train(configs: dict, model_configs: dict | None = None, seed: int = 999,
          max_steps: int | None = None, device: str | torch.device | None = "cuda",
          record_losses: list | None = None, plan: MeshPlan | None = None) -> TrainState:
    """The JAX ``train()``: the per-observation train loader, the DDPM from
    the factory (seeded from ``seed``), Adam at the model config's
    ``learning_rate`` (default: the config's, else 1e-4), ``epochs`` of
    steps with a print every ``print_frequency`` steps, ``diffusion_{e}``
    under ``checkpoint_path`` after each epoch. ``max_steps`` ends the
    epoch loop too, after that epoch's save. ``record_losses`` receives
    each step's loss (a host read a step). Runs on the card unless
    ``device`` says otherwise; data parallel over ``plan``'s data group.
    Returns the train state."""
    model_configs = model_configs or {"learning_rate": configs.get("learning_rate", 1e-4)}
    configs = dict(configs, task="diffusion-unsup")
    dev = resolve_device(device)
    configure_backends(configs, dev)
    loader = Loader("train", configs, seed=seed)
    model = initialize_segmentation_model(configs, model_configs, device=dev, seed=seed)
    broadcast_module(model, plan.data_grid() if plan is not None else None)
    state = create_train_state(model, configs, model_configs, "segmentation")
    step_fn = make_diffusion_train_step(model, dev, plan)
    generator = torch.Generator(dev).manual_seed(int(seed))
    ckpt = CheckpointManager(configs.get("checkpoint_path", "checkpoints/diffusion-unsup"), dev)
    print_every = int(configs.get("print_frequency", 10))
    steps = 0
    try:
        for epoch in range(int(configs.get("epochs", 1))):
            batches = device_prefetch(loader, dev, keys=("image",))
            for idx, batch in enumerate(batches):
                state, loss = step_fn(state, batch, generator)
                steps += 1
                if record_losses is not None:
                    record_losses.append(float(loss))
                if idx % print_every == 0:
                    print(f"diffusion epoch {epoch} iter {idx}: loss={float(loss):.5f}",
                          flush=True)
                if max_steps and steps >= max_steps:
                    break
            batches.close()
            ckpt.save(f"diffusion_{epoch}", state)
            if max_steps and steps >= max_steps:
                break  # a capped run ends the epoch loop too
    finally:
        loader.close()
    return state
