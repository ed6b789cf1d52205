"""MAE (FloodViT) self-supervised pretraining; counterpart of
``kurosiwo_tpu/training/mae.py``: the train step and the epoch loop
``train()`` (the reference's ``training/train_mae.py:40-232``):

  * lr scaled by the gradient-accumulation factor;
  * the per-iteration warmup + half-cycle cosine schedule on fractional
    epochs (``ops/schedules.mae_warmup_cosine``);
  * gradient accumulation over microbatches inside the step, one optimizer
    update a step;
  * per-epoch checkpoints ``mae_{e}`` (the whole state) and ``vit_{e}`` (the
    encoder's own ``state_dict``, no optimizer), through
    ``training/checkpoint.CheckpointManager``.

Masking noise comes from one ``torch.Generator`` on the step's device,
seeded from the seed; ``jax.random``'s stream is not replayed (ROADMAP.md,
C7), so the same seed gives other masks than the JAX package's.

Under data parallelism (a ``MeshPlan``, ``parallel/mesh.py``) each rank
decodes its row block of every global batch (the SSL loader's process
grid), draws the global batch's masking noise and keeps its rows, runs B4
on its own rows and averages the gradients over the data group before the
update, as the JAX step's mean over the sharded batch gives them: the loss
is a mean over samples that each mask as many patches, so the mean of the
ranks' means is the global mean, whichever microbatch a sample falls in.
"""

from __future__ import annotations

import time

import torch

from ..config import load_json5
from ..data.ssl import SSLLoader
from ..device import configure_backends, resolve_device
from ..models.factory import build_mae
from ..ops.optim import set_learning_rate
from ..ops.schedules import mae_warmup_cosine
from ..parallel.mesh import (MeshPlan, all_reduce_sum, broadcast_module, global_rows,
                             sync_gradients, use_grid)
from .checkpoint import CheckpointManager
from .engine import device_prefetch
from .state import TrainState, create_train_state


def make_mae_train_step(model: torch.nn.Module, accum: int = 1,
                        device: str | torch.device | None = "cuda",
                        plan: MeshPlan | None = None):
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
    With ``plan`` the step is data parallel (see the module docstring): the
    drawn noise is the global batch's rows of this rank, and the loss and
    gradients are the means over the data group.
    """
    dev = resolve_device(device)
    num_patches = model.encoder.num_patches
    grid = plan.data_grid() if plan is not None else None

    def train_step(state: TrainState, batch: dict, lr: float,
                   generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        with use_grid(grid):
            return _train_step(state, batch, lr, generator, noise)

    def _train_step(state, batch, lr, generator, noise):
        images = torch.as_tensor(batch["image"]).to(dev, non_blocking=True)
        micro = images.shape[0] // accum
        if noise is None:
            # the microbatches' draws of one process on the global batch, in
            # order, then this rank's rows of them
            total, rows = global_rows(images.shape[0])
            drawn = torch.cat([torch.rand((total // accum, num_patches), generator=generator,
                                          device=dev) for _ in range(accum)])[rows]
        model.train()
        set_learning_rate(state.optimizer, lr)
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = None
        for i in range(accum):
            if noise is None:
                mask_noise = drawn[i * micro:(i + 1) * micro]
            else:
                mask_noise = torch.as_tensor(noise[i]).to(dev)
            loss = model(images[i * micro:(i + 1) * micro], mask_noise)
            loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        if accum > 1:
            torch._foreach_div_([p.grad for p in model.parameters() if p.grad is not None],
                                float(accum))
        sync_gradients(model.parameters(), grid, average=True)
        state.optimizer.step()
        state.step += 1
        loss = loss_sum / accum
        if grid is not None:
            loss = all_reduce_sum(loss, grid) / grid.count
        return state, loss

    return train_step


def train(configs: dict, seed: int = 999, model_configs: dict | None = None,
          max_steps: int | None = None, record_losses: list | None = None,
          device: str | torch.device | None = "cuda", plan: MeshPlan | None = None) -> TrainState:
    """MAE pretraining, the JAX ``train()`` (the reference's
    ``train_mae.train(configs)``): ``{**configs, **model_configs}`` (default
    model config ``configs/method/mae/mae.json``), lr = ``learning_rate`` x
    ``accumulate_gradients`` (``lr_scales`` from the merged config), the
    SSL loader's epochs, the schedule at ``idx / steps_per_epoch + epoch``,
    a print at ``print_frequency`` and at each epoch's end (its seconds,
    the card's work included, and the seconds spent waiting for batches),
    then ``mae_{e}`` and ``vit_{e}``. ``max_steps`` ends the run after that
    many steps, saving ``mae_{e}`` only; ``record_losses`` receives each
    step's loss (a host read a step). Runs on the card unless ``device``
    says otherwise; data parallel over ``plan``'s data group. Returns the
    train state."""
    if model_configs is None:
        model_configs = load_json5("configs/method/mae/mae.json")
    configs = {**configs, **model_configs}
    accum = int(configs.get("accumulate_gradients", 1))
    configs["lr"] = float(configs["learning_rate"]) * accum
    dev = resolve_device(device)
    configure_backends(configs, dev)

    loader = SSLLoader(configs, seed=seed)
    model = build_mae(configs, configs, device=dev, seed=seed)
    broadcast_module(model, plan.data_grid() if plan is not None else None)
    state = create_train_state(model, configs, {"learning_rate": configs["lr"]}, task="mae")
    schedule = mae_warmup_cosine(configs["lr"], float(configs.get("min_lr", 0.0)),
                                 float(configs.get("warmup_epochs", 10)),
                                 float(configs.get("epochs", 1)))
    step_fn = make_mae_train_step(model, accum, device=dev, plan=plan)
    generator = torch.Generator(dev).manual_seed(int(seed))
    ckpt = CheckpointManager(configs.get("checkpoint_path", "checkpoints/mae"), dev)
    steps_per_epoch = max(len(loader), 1)
    print_every = int(configs.get("print_frequency", 10))
    total_steps = 0
    try:
        for epoch in range(int(configs.get("epochs", 1))):
            t0 = time.perf_counter()
            data_time = 0.0
            batches = device_prefetch(loader, dev, keys=("image",))
            idx = 0
            while max_steps is None or total_steps < max_steps:
                t = time.perf_counter()
                batch = next(batches, None)
                data_time += time.perf_counter() - t
                if batch is None:
                    break
                lr_value = float(schedule(idx / steps_per_epoch + epoch))
                state, loss = step_fn(state, batch, lr_value, generator)
                total_steps += 1
                if record_losses is not None:
                    record_losses.append(float(loss))
                if idx % print_every == 0:
                    print(f"MAE epoch {epoch} iter {idx}: loss={float(loss):.5f} "
                          f"lr={lr_value:.3e}", flush=True)
                idx += 1
            batches.close()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"MAE epoch {epoch}: {time.perf_counter() - t0:.1f}s "
                  f"(data {data_time:.1f}s)", flush=True)
            ckpt.save(f"mae_{epoch}", state)
            if max_steps is not None and total_steps >= max_steps:
                # a capped run ends the epoch loop too, without vit_{e}
                break
            # the encoder alone: the reference's whole-encoder vit_{e}.pt
            ckpt.save(f"vit_{epoch}", TrainState(step=state.step, model=model.encoder,
                                                 optimizer=None))
    finally:
        loader.close()
    return state
