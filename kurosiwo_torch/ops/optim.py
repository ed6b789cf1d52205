"""Optimizer factory; counterpart of ``kurosiwo_tpu/ops/optim.py`` for the
segmentation trainer (plain Adam, the reference's
``segmentation_trainer.py:35``), MAE pretraining (Adam with bf16 moment
storage, ``scale_by_adam_bf16``) and change detection (the reference's
``change_detection_trainer.py:44-66`` choice, ``optim.py:174-200``).

``torch.optim.Adam`` computes optax.adam's update: bias-corrected moments,
eps outside the square root, no eps_root. It keeps f32 moments, so the MAE
default is :class:`AdamBF16Moments`. The learning rate is set before each
step (``set_learning_rate``), as the JAX step injects it.

``lr_scales`` (the segmentation and MAE tasks; JAX ``lr_scale_by_path``,
``optim.py:31-64``) become parameter groups, one for each distinct scale,
each with its ``lr_scale``: scaling Adam's update is scaling its group's lr,
and ``set_learning_rate`` sets each group's lr to lr x ``lr_scale``.
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
    parameter update, not a loop of launches per parameter.
    ``load_state_dict`` copies the restored moments back into the flat
    buffers, so a checkpoint round trip is bitwise.
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

    def load_state_dict(self, state_dict: dict) -> None:
        # the base class puts the moments into new tensors of the parameters'
        # dtype (f32, exact for bf16 values); copy them into the flat bf16
        # buffers and point the state at their views again
        super().load_state_dict(state_dict)
        with torch.no_grad():
            for group, (m, v) in zip(self.param_groups, self._flat):
                ps = group["params"]
                sizes = [p.numel() for p in ps]
                for p, mv, vv in zip(ps, m.split(sizes), v.split(sizes)):
                    mv, vv = mv.view_as(p), vv.view_as(p)
                    mv.copy_(self.state[p]["exp_avg"])
                    vv.copy_(self.state[p]["exp_avg_sq"])
                    self.state[p] = {"exp_avg": mv, "exp_avg_sq": vv}

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


def flax_path(name: str) -> str:
    """The flax path of one of the port's parameter names: the port names
    its modules after the flax tree (``convert.py``), so it is the name with
    ``.`` as ``/`` and the leaf renamed as ``convert.flax_to_torch`` renames
    it (``weight`` is flax's ``kernel``)."""
    *path, leaf = name.split(".")
    return "/".join(path + ["kernel" if leaf == "weight" else leaf])


def lr_scale_groups(named_params, scales: dict) -> list[dict]:
    """Parameter groups of ``lr_scales``: each parameter takes the scale of
    the first pattern that is a substring of its flax path (``flax_path``),
    else 1.0, as JAX's ``lr_scale_by_path`` selects it; one group for each
    distinct scale, in the order of its first parameter, each with its
    ``lr_scale``."""
    patterns = [(str(pat), float(s)) for pat, s in scales.items()]
    groups: dict[float, list] = {}
    for name, p in named_params:
        path = flax_path(name)
        scale = next((s for pat, s in patterns if pat in path), 1.0)
        groups.setdefault(scale, []).append(p)
    return [{"params": ps, "lr_scale": s} for s, ps in groups.items()]


def _split_names(params) -> tuple[list, list | None]:
    """(parameters, names or None) of an iterable of parameters or of
    (name, parameter) pairs."""
    items = list(params)
    if items and isinstance(items[0], tuple):
        return [p for _, p in items], [n for n, _ in items]
    return items, None


def _sgd(params, lr: float, model_config: dict) -> torch.optim.Optimizer:
    """optax's chain(add_decayed_weights(wd), sgd(lr, momentum)), the JAX
    ``_sgd``: the decay is added to the gradient, the momentum trace starts
    at the first gradient, no dampening and no Nesterov; torch's SGD is that
    update."""
    return torch.optim.SGD(params, lr=lr, momentum=float(model_config.get("momentum", 0.9)),
                           weight_decay=float(model_config.get("weight_decay", 0.0)))


def create_cd_optimizer(params, config: dict, model_config: dict) -> torch.optim.Optimizer:
    """The change-detection choice: bit-cd and hfa-net are forced to SGD with
    momentum and weight decay; otherwise the model config's ``optimizer``:
    ``adam`` is optax.adam with its defaults (0.9, 0.999, 1e-8; the config's
    ``betas`` are not read, as the JAX package does not read them there),
    ``adamw`` takes the config's betas and weight decay, ``sgd`` is the same
    SGD."""
    lr = float(model_config.get("learning_rate", config.get("learning_rate", 1e-3)))
    if config.get("method", "") in ("bit-cd", "hfa-net"):
        return _sgd(params, lr, model_config)
    name = model_config.get("optimizer", "adam")
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        b1, b2 = model_config.get("betas", [0.9, 0.999])
        return torch.optim.AdamW(params, lr=lr, betas=(float(b1), float(b2)), eps=1e-8,
                                 weight_decay=float(model_config.get("weight_decay", 0.0)))
    if name == "sgd":
        return _sgd(params, lr, model_config)
    raise NotImplementedError(f"optimizer {name!r} is not supported")


def create_optimizer(params, config: dict, model_config: dict,
                     task: str = "segmentation") -> torch.optim.Optimizer:
    """The optimizer of ``task`` over ``params`` (parameters, or (name,
    parameter) pairs as ``named_parameters`` gives them; ``lr_scales``
    needs the names). ``"cd"`` is the change-detection choice; the
    segmentation and MAE tasks take Adam, with bf16 moments where
    ``resolve_moment_dtype`` says so, and honour ``lr_scales`` (the model
    config's, else the config's), as the JAX ``create_optimizer`` does. The
    recurrent engine asks for the segmentation optimizer, as JAX's does."""
    params, names = _split_names(params)
    if task == "cd":  # JAX's cd branch reads no lr_scales
        return create_cd_optimizer(params, config, model_config)
    if task not in ("segmentation", "mae"):
        raise NotImplementedError(f"no optimizer for task {task!r}")
    lr = float(model_config.get("learning_rate", config.get("learning_rate", 1e-3)))
    scales = model_config.get("lr_scales") or config.get("lr_scales")
    if scales:
        if names is None:
            raise ValueError("lr_scales selects parameters by name: pass named_parameters()")
        params = lr_scale_groups(zip(names, params), scales)
    cls = (AdamBF16Moments if resolve_moment_dtype(config, model_config, task) == "bfloat16"
           else torch.optim.Adam)
    optimizer = cls(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    set_learning_rate(optimizer, lr)
    return optimizer


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's lr to ``lr`` times the group's ``lr_scale`` (1 where
    it has none)."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)
