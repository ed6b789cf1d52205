"""Optimizer factory; counterpart of ``kurosiwo_tpu/ops/optim.py`` for the
segmentation trainer (plain Adam, the reference's
``segmentation_trainer.py:35``) and MAE pretraining (Adam with bf16 moment
storage, ``scale_by_adam_bf16``).

``torch.optim.Adam`` computes optax.adam's update: bias-corrected moments,
eps outside the square root, no eps_root. It keeps f32 moments, so the MAE
default is :class:`AdamBF16Moments`. The learning rate is set before each
step (``set_learning_rate``), as the JAX step injects it.
"""

from __future__ import annotations

import torch


def resolve_moment_dtype(config: dict, model_config: dict | None, task: str) -> str:
    """The Adam moment-storage dtype; the train step's gradient hand-off
    dtype follows it (bf16 moments, bf16 gradients)."""
    return str(
        (model_config or {}).get(
            "optimizer_moment_dtype",
            config.get("optimizer_moment_dtype",
                       "bfloat16" if task == "mae" else "float32")))


class AdamBF16Moments(torch.optim.Optimizer):
    """optax ``scale_by_adam_bf16`` followed by ``scale_by_learning_rate``:
    the first and second moments are STORED in bf16, every operation on
    them is f32, parameters stay f32 masters:

        m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2   (f32, stored bf16)
        p -= lr (m / bc1) / (sqrt(v / bc2) + eps)

    The gradient is handed in rounded to bf16, as the JAX MAE step rounds
    it. A parameter without a gradient takes g = 0, as optax updates the
    whole tree. The moments of a parameter group live in one flat bf16
    buffer each (``state[p]["exp_avg"]`` and ``["exp_avg_sq"]`` are views of
    them), so a step is a few passes over flat tensors and one multi-tensor
    parameter update, not a loop of launches per parameter. Saving and
    restoring this state is not ported yet (checkpoints, ROADMAP.md A4).
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))
        self._flat = []
        for group in self.param_groups:
            group["step"] = 0
            ps = group["params"]
            total = sum(p.numel() for p in ps)
            m = torch.zeros(total, dtype=torch.bfloat16, device=ps[0].device)
            v = torch.zeros_like(m)
            for p, mv, vv in zip(ps, m.split([p.numel() for p in ps]),
                                 v.split([p.numel() for p in ps])):
                self.state[p] = {"exp_avg": mv.view_as(p), "exp_avg_sq": vv.view_as(p)}
            self._flat.append((m, v))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("AdamBF16Moments.step takes no closure")
        for group, (m, v) in zip(self.param_groups, self._flat):
            ps = group["params"]
            b1, b2 = group["betas"]
            group["step"] += 1
            t = group["step"]
            bc1, bc2 = 1.0 - b1**t, 1.0 - b2**t
            g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           for p in ps]).to(torch.bfloat16)
            mf = m.float().mul_(b1).add_(g, alpha=1.0 - b1)
            vf = v.float().mul_(b2).addcmul_(g, g, value=1.0 - b2)
            del g
            m.copy_(mf)
            v.copy_(vf)
            u = mf.div_(bc1).div_(vf.div_(bc2).sqrt_().add_(group["eps"]))
            updates = [x.view_as(p) for x, p in zip(u.split([p.numel() for p in ps]), ps)]
            torch._foreach_add_(ps, updates, alpha=-group["lr"])
        return None


def create_optimizer(params, config: dict, model_config: dict,
                     task: str = "segmentation") -> torch.optim.Optimizer:
    if task not in ("segmentation", "mae"):
        raise NotImplementedError(
            f"optimizer for task {task!r} is not ported yet (ROADMAP.md, A6-A7)")
    if model_config.get("lr_scales") or config.get("lr_scales"):
        raise NotImplementedError("lr_scales is not ported yet (ROADMAP.md, A8)")
    lr = float(model_config.get("learning_rate", config.get("learning_rate", 1e-3)))
    if resolve_moment_dtype(config, model_config, task) == "bfloat16":
        return AdamBF16Moments(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
