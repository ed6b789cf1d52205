"""The ("data", "model") grid of ranks; counterpart of
``kurosiwo_tpu/parallel/mesh.py``.

  data  -- batch sharding (data parallelism). Each rank holds its row block
           of the global batch, and the step reduces over the data group
           whatever the JAX step reduces over the global batch: the
           BatchNorm statistics (``ops/batchnorm.py``), the loss's
           normaliser (``ops/losses.py``), the metric banks
           (``ops/metrics.MetricState.reduce``) and the gradients
           (``sync_gradients``); the random draws are made for the global
           batch on every rank (``draw_rows``).
  model -- the tensor-parallel axis (``parallel/sharding.py``): a
           parameter that JAX's rule shards holds this rank's slice, and
           the layers that own one compute their output slice and join it
           through the model group's collectives below (``copy_in``,
           ``gather_out``, ``reduce_out``, ``slice_in``). The same axis
           carries context-parallel ring attention over the token sequence
           of a whole scene (``ops/ring_attention.py``), as in JAX; a model
           sharded over it does not also take a ring.

Ranks are laid out as the JAX mesh lays out devices: rank = d * num_model + m.
One process is a 1 x 1 grid with no groups, and the same steps run
unchanged.

JAX's ``batch_sharding`` and ``replicated`` have no counterpart: a rank
holds its own rows (the loaders decode only those) and a replica of the
state, so there is no sharding to describe.

The step finds its data group through ``use_grid``, which the steps set
around their forward and backward; the BatchNorm, loss and dropout layers
read it (``active_grid``) as they read the remat region. It is a module
variable rather than a context variable because the backward pass runs on
autograd's device threads.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from .distributed import process_info


@dataclasses.dataclass(frozen=True)
class DataGrid:
    """This rank's place on the data axis: its group (None: the default
    group), its index and the axis size."""

    group: Any
    index: int
    count: int


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    num_data: int = 1
    num_model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None     # the ranks that share this rank's model index
    model_group: Any = None    # the ranks that share this rank's data index
    data_axis: str = "data"
    model_axis: str = "model"

    @property
    def distributed(self) -> bool:
        """Whether the plan's groups exist (a process group was joined)."""
        return self.data_group is not None

    def data_grid(self) -> DataGrid | None:
        if not self.distributed:
            return None
        return DataGrid(self.data_group, self.data_index, self.num_data)

    def model_grid(self) -> DataGrid | None:
        """This rank's place on the model axis, or None where the axis has
        one rank (there is nothing to shard over)."""
        if not self.distributed or self.num_model == 1:
            return None
        return DataGrid(self.model_group, self.model_index, self.num_model)


def _group(ranks: list[int]):
    """The process group of ``ranks``: the default group where they are all
    ranks, else a new group that only its members build."""
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks, use_local_synchronization=True)


def create_mesh(num_data: int | None = None, num_model: int = 1) -> MeshPlan:
    """The grid over the process group's ranks (every rank calls it); one
    process without a group is the 1 x 1 grid."""
    rank, world = process_info()
    if num_data is None:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(f"mesh {num_data}x{num_model} != {world} processes")
    if not (dist.is_available() and dist.is_initialized()):
        return MeshPlan()
    d, m = divmod(rank, num_model)
    data_group = _group([r * num_model + m for r in range(num_data)])
    model_group = _group([d * num_model + c for c in range(num_model)])
    return MeshPlan(num_data, num_model, d, m, data_group, model_group)


def shard_batch(plan: MeshPlan, batch: dict, device: str | torch.device) -> dict:
    """A rank's LOCAL rows (the loader decodes only those) on its device."""
    dev = torch.device(device)
    return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}


# -- the active data grid -----------------------------------------------------

_GRID: DataGrid | None = None


def active_grid() -> DataGrid | None:
    """The data grid of the running step, or None outside data parallelism."""
    return _GRID


@contextlib.contextmanager
def use_grid(grid: DataGrid | None):
    global _GRID
    prev, _GRID = _GRID, grid
    try:
        yield grid
    finally:
        _GRID = prev


def all_reduce_sum(t: torch.Tensor, grid: DataGrid | None = None) -> torch.Tensor:
    """A new tensor: ``t`` summed over the data group (``t`` itself without
    one)."""
    grid = grid if grid is not None else _GRID
    if grid is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=grid.group)
    return out


class _GlobalSum(torch.autograd.Function):
    """Forward: the sum over the data group. Backward: the incoming gradient
    unchanged, to this rank's own term. Every rank computes the same loss
    from the summed value, so summing the ranks' parameter gradients
    afterwards (``sync_gradients``) gives the global batch's gradient."""

    @staticmethod
    def forward(ctx, t, grid):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=grid.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active data group, differentiable as
    ``_GlobalSum``; ``t`` itself outside data parallelism."""
    grid = _GRID
    if grid is None:
        return t
    if not t.requires_grad:
        return all_reduce_sum(t, grid)
    return _GlobalSum.apply(t, grid)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of per-sample terms ``t`` over the global batch (every rank
    holds as many); ``t.mean()`` outside data parallelism."""
    grid = _GRID
    if grid is None:
        return t.mean()
    return global_sum(t.sum()) / (t.numel() * grid.count)


def gather_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The data group's ``t`` concatenated along ``dim`` in rank order (the
    global batch's order); ``t`` outside data parallelism. No gradient."""
    grid = _GRID
    if grid is None:
        return t
    parts = [torch.empty_like(t) for _ in range(grid.count)]
    dist.all_gather(parts, t.contiguous(), group=grid.group)
    return torch.cat(parts, dim=dim)


def global_rows(local: int) -> tuple[int, slice]:
    """(global batch size, this rank's rows) for a local batch of ``local``."""
    grid = _GRID
    if grid is None:
        return local, slice(0, local)
    return local * grid.count, slice(grid.index * local, (grid.index + 1) * local)


def draw_rows(draw: Callable[[int], Any], local: int) -> Any:
    """``draw(global batch size)``'s random values, each tensor cut to this
    rank's rows along its leading (batch) axis. Every rank draws the whole
    global batch from the same generator state, so a P-rank run draws what
    one process does. Tensors that are the same object stay so."""
    total, rows = global_rows(local)
    drawn = draw(total)
    if total == local:
        return drawn
    memo: dict = {}

    def cut(x):
        if torch.is_tensor(x):
            if id(x) not in memo:
                memo[id(x)] = x[rows]
            return memo[id(x)]
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        return x

    return cut(drawn)


def broadcast_module(module: torch.nn.Module, grid: DataGrid | None) -> None:
    """The data group's first rank's parameters and buffers on every rank
    of the group (the replicas start equal, as DDP makes them)."""
    if grid is None:
        return
    src = dist.get_global_rank(grid.group, 0) if grid.group is not None else 0
    for t in [*module.parameters(), *module.buffers()]:
        dist.broadcast(t.data, src=src, group=grid.group)


# -- gradients ----------------------------------------------------------------

def sync_gradients(params, grid: DataGrid | None = None, average: bool = False) -> None:
    """Sum (``average``: and divide by the group size) the parameters'
    gradients over the data group in one all-reduce of a flat buffer;
    nothing outside data parallelism."""
    grid = grid if grid is not None else _GRID
    if grid is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=grid.group)
    if average:
        flat.div_(grid.count)
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


# -- the model axis: tensor parallelism -----------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelShard:
    """How a parameter is cut over the model group: its slice ``index`` of
    ``count`` along ``dim``, a contiguous block (``layout="block"``) or, for
    a packed (q | k | v) projection, the block of each third
    (``layout="thirds"``: rank m holds rows m of q, of k and of v, so the
    heads it computes are whole). ``full`` is the unsharded shape."""

    group: Any
    index: int
    count: int
    dim: int
    full: tuple
    layout: str = "block"

    def cut(self, t: torch.Tensor, dim: int | None = None) -> torch.Tensor:
        """This rank's slice of the full tensor ``t`` (a view where it can
        be); ``dim`` overrides the parameter's dim (an activation's)."""
        dim = self.dim if dim is None else dim % t.dim()
        if self.layout == "thirds":
            n = t.shape[dim]
            parts = t.unflatten(dim, (3, self.count, n // (3 * self.count)))
            return parts.select(dim + 1, self.index).flatten(dim, dim + 1)
        size = t.shape[dim] // self.count
        return t.narrow(dim, self.index * size, size)

    def join(self, parts: list[torch.Tensor], dim: int | None = None) -> torch.Tensor:
        """The full tensor from every rank's slice, in rank order (the
        inverse of ``cut``)."""
        dim = self.dim if dim is None else dim % parts[0].dim()
        if self.layout == "thirds":
            thirds = [p.unflatten(dim, (3, p.shape[dim] // 3)) for p in parts]
            return torch.stack(thirds, dim + 1).flatten(dim, dim + 2)
        return torch.cat(parts, dim)

    def gather(self, t: torch.Tensor, dim: int | None = None) -> torch.Tensor:
        """Every rank's slice ``t`` joined (no gradient)."""
        parts = [torch.empty_like(t) for _ in range(self.count)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return self.join(parts, dim)


class _CopyIn(torch.autograd.Function):
    """Forward: the replicated input as it is. Backward: the ranks' partial
    input gradients summed over the model group (each rank's slice of the
    layer's outputs gives one part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.shard.group)
        return grad, None


class _GatherOut(torch.autograd.Function):
    """Forward: the ranks' output slices joined along ``dim``. Backward:
    this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return shard.gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.cut(grad, ctx.dim).contiguous(), None, None


class _ReduceOut(torch.autograd.Function):
    """Forward: the ranks' partial outputs summed over the model group.
    Backward: the (replicated) gradient as it is, to each rank's part."""

    @staticmethod
    def forward(ctx, x, shard):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=shard.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SliceIn(torch.autograd.Function):
    """Forward: this rank's slice of a replicated tensor along ``dim``.
    Backward: the ranks' slice gradients joined, so that the replicated
    tensor's gradient is whole and the same on every rank."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return shard.cut(x, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.gather(grad, ctx.dim), None, None


def copy_in(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return _CopyIn.apply(x, shard)


def gather_out(x: torch.Tensor, shard: ModelShard, dim: int = -1) -> torch.Tensor:
    return _GatherOut.apply(x, shard, dim)


def reduce_out(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return _ReduceOut.apply(x, shard)


def slice_in(x: torch.Tensor, shard: ModelShard, dim: int = -1) -> torch.Tensor:
    return _SliceIn.apply(x, shard, dim)


def shard_of(module: torch.nn.Module, name: str = "weight") -> ModelShard | None:
    """The ``ModelShard`` of ``module``'s parameter ``name``, or None where
    it is whole (``parallel/sharding.apply_shardings`` records them)."""
    return module.__dict__.get("tp_shards", {}).get(name)


def full_param(module: torch.nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name`` whole: the parameter itself, or its
    slices gathered over the model group (differentiable: the gradient of
    the whole goes back as this rank's slice of it)."""
    t = getattr(module, name)
    shard = shard_of(module, name)
    if shard is None or tuple(t.shape) == shard.full:
        return t
    return _GatherOut.apply(t, shard, None)
