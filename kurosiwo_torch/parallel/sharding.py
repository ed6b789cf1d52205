"""Parameter partition rules for tensor parallelism; counterpart of
``kurosiwo_tpu/parallel/sharding.py``.

The rule is JAX's ``_spec_for``, read on the flax form of each parameter
(``convert.py``'s bridge): a leaf is sharded over the model axis when it
has at least 2 dimensions and ``min_size`` elements, and its last flax axis
(its output features) divides by the axis size with at least 8 features a
rank; every other leaf is replicated. The flax last axis of a ``weight``
(a Dense kernel (in, out) is the (out, in) weight; a conv kernel HWIO the
OIHW weight; the transposed conv's HWOI kernel the IOHW weight) is torch
dim 0; of any other parameter (``pos_embedding``, an ``embedding``) its
own last dim.

Where JAX lets GSPMD resolve the rest, the port's layers compute on their
slices (``ops/nn.Dense``, ``Conv``, ``ConvBNAct``, ``TorchConvTranspose``,
``models/vit.py``): a column-parallel layer holds its output features and
joins them at its output; its BatchNorm normalises its channel slice. A
module may cut a picked leaf otherwise through ``tp_layouts`` (the ViT's
attention cuts ``to_qkv`` by head and ``to_out``, ``fc2`` on their input
features: ROADMAP C26); the picked leaves, and their gathered values, are
JAX's. Any other module that owns a picked leaf gets it whole for its
forward (the slices gathered at its start).

Adam's moments follow their parameter: ``apply_shardings`` cuts the
optimizer's state tensors of a cut parameter, and a fresh optimizer made
after it holds slices. ``gather_state`` rebuilds the whole state on every
rank, which is what a checkpoint holds (``training/checkpoint.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import MeshPlan, ModelShard, full_param, shard_of

DEFAULT_MIN_SIZE = 1 << 16
MIN_FEATURES = 8


def flax_shape(name: str, shape: tuple) -> tuple:
    """The flax leaf's shape of a parameter named ``name`` of torch shape
    ``shape`` (``convert.torch_to_flax``'s transposes)."""
    if name.rsplit(".", 1)[-1] == "weight":
        return tuple(shape[i] for i in (2, 3, 1, 0)) if len(shape) == 4 else tuple(shape[::-1])
    return tuple(shape)


def spec_for(shape: tuple, num_model: int, min_size: int = DEFAULT_MIN_SIZE) -> bool:
    """JAX's ``_spec_for`` on a flax leaf's shape: whether the leaf is
    sharded over the model axis (its last axis)."""
    if num_model <= 1:
        return False
    if len(shape) < 2 or int(np.prod(shape)) < min_size:
        return False
    out_features = shape[-1]
    return out_features % num_model == 0 and out_features // num_model >= MIN_FEATURES


def torch_dim(name: str, ndim: int) -> int:
    """The torch dim of a parameter's flax last axis."""
    return 0 if name.rsplit(".", 1)[-1] == "weight" else ndim - 1


def param_shardings(plan: MeshPlan, module: torch.nn.Module,
                    min_size: int = DEFAULT_MIN_SIZE) -> dict[str, int | None]:
    """{parameter name: the torch dim JAX's rule shards it on, or None} for
    every parameter of ``module`` (its flax leaf's last axis, mapped)."""
    out = {}
    for name, p in module.named_parameters():
        picked = spec_for(flax_shape(name, tuple(p.shape)), plan.num_model, min_size)
        out[name] = torch_dim(name, p.dim()) if picked else None
    return out


def state_shardings(plan: MeshPlan, module: torch.nn.Module,
                    min_size: int = DEFAULT_MIN_SIZE) -> dict[str, int | None]:
    """The same rule for the whole train state: the optimizer's moments
    follow their parameter's (``apply_shardings`` cuts them with it)."""
    return param_shardings(plan, module, min_size)


def _layouts(module: torch.nn.Module, num_model: int) -> dict[str, tuple[int, str]]:
    """{parameter name: (dim, layout)} of the modules that cut a picked
    leaf their own way (``tp_layouts``)."""
    out = {}
    for prefix, m in module.named_modules():
        fn = getattr(m, "tp_layouts", None)
        if fn is None:
            continue
        for name, layout in fn(num_model).items():
            out[f"{prefix}.{name}" if prefix else name] = layout
    return out


def _owners(module: torch.nn.Module) -> dict[str, tuple[torch.nn.Module, str]]:
    """{parameter name: (its owning module, its name there)}."""
    return {f"{prefix}.{n}" if prefix else n: (m, n) for prefix, m in module.named_modules()
            for n, _ in m.named_parameters(recurse=False)}


def _gather_for_forward(module: torch.nn.Module, names: list[str]) -> None:
    """Hooks that hand ``module``'s forward its cut parameters whole (the
    slices gathered, differentiable) and put the slices back after."""

    def pre(mod, args):
        mod.__dict__["tp_saved"] = {n: mod._parameters[n] for n in names}
        for n in names:
            mod._parameters[n] = full_param(mod, n)

    def post(mod, args, out):
        mod._parameters.update(mod.__dict__.pop("tp_saved"))
        return out

    module.register_forward_pre_hook(pre)
    module.register_forward_hook(post)


def apply_shardings(plan: MeshPlan, module: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None,
                    min_size: int = DEFAULT_MIN_SIZE) -> dict[str, ModelShard]:
    """Replace each parameter that JAX's rule picks by this rank's slice of
    it (in place: the same ``Parameter`` objects, so an optimizer keeps
    them), and cut ``optimizer``'s state tensors of it alike. Returns the
    cuts by parameter name. Every rank calls it with the same whole
    parameters. Nothing changes where the plan's model axis has one rank.
    A model sharded so takes no ring (``vit_whole_scene_cp`` refuses it)."""
    grid = plan.model_grid()
    if grid is None:
        return {}
    picks = param_shardings(plan, module, min_size)
    own = _layouts(module, plan.num_model)
    owners = _owners(module)
    cuts: dict[str, ModelShard] = {}
    hooked: dict[int, tuple] = {}
    for name, dim in picks.items():
        if dim is None:
            continue
        mod, leaf = owners[name]
        p = getattr(mod, leaf)
        dim, layout = own.get(name, (dim, "block"))
        size = p.shape[dim]
        if size % (3 * grid.count if layout == "thirds" else grid.count):
            raise ValueError(f"{name} {tuple(p.shape)}: dim {dim} does not cut into "
                             f"{grid.count} {layout}")
        shard = ModelShard(grid.group, grid.index, grid.count, dim, tuple(p.shape), layout)
        state = optimizer.state.get(p, {}) if optimizer is not None else {}
        for k, v in state.items():
            if torch.is_tensor(v) and v.shape == p.shape:
                state[k] = shard.cut(v).clone()
        with torch.no_grad():
            p.data = shard.cut(p.data).clone()
        mod.__dict__.setdefault("tp_shards", {})[leaf] = shard
        cuts[name] = shard
        # the layers that compute on their own slices say so (``tp_aware``:
        # ops/nn.py, models/vit.py); any other owner takes the whole
        if not getattr(type(mod), "tp_aware", False):
            hooked.setdefault(id(mod), (mod, []))[1].append(leaf)
    for mod, names in hooked.values():
        _gather_for_forward(mod, names)
    return cuts


def is_sharded(module: torch.nn.Module) -> bool:
    """Whether ``apply_shardings`` cut any of ``module``'s parameters."""
    return any(m.__dict__.get("tp_shards") for m in module.modules())


def gather_state(module: torch.nn.Module, optimizer: torch.optim.Optimizer | None = None
                 ) -> tuple[dict, dict | None]:
    """(the whole ``state_dict``, the whole optimizer ``state_dict``) on
    every rank: each cut parameter's, and its moments', slices gathered
    over the model group. A collective: every rank of the group calls it."""
    owners = _owners(module)
    shards = {name: shard_of(*owners[name]) for name in owners}
    state = {k: shards[k].gather(t) if shards.get(k) is not None else t
             for k, t in module.state_dict().items()}
    if optimizer is None:
        return state, None
    by_param = {id(getattr(*owners[k])): sh for k, sh in shards.items() if sh is not None}
    opt_state = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        shard, moments = by_param.get(id(p)), opt_state["state"].get(i)
        if shard is not None and moments is not None:
            opt_state["state"][i] = {k: shard.gather(v) if torch.is_tensor(v) and
                                     v.shape == p.shape else v for k, v in moments.items()}
    return state, opt_state
