"""Multi-process runtime; counterpart of ``kurosiwo_tpu/parallel/distributed.py``.

One process per rank, joined by ``torch.distributed``:

  * ``initialize`` wires the process group from the config keys
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``, or from the launcher's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` (``python -m torch.distributed.run`` sets
    them, with ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``);
  * every process loads only its row block of each global batch (the
    loaders' process grid, ``data/pipeline.resolve_process_grid``) and the
    step reduces over the data group what the JAX step reduces over the
    global batch (``parallel/mesh.py``).

Determinism contract, as in the JAX package: all processes compute the same
global epoch indices from the same seed, then each decodes rows
[pi*local_bs, (pi+1)*local_bs) of every batch, so an N-process run consumes
the same global batches as one process.

A rank runs on ``cuda:LOCAL_RANK`` unless the caller asks for the CPU; ranks
of one node that outnumber its cards share them (``LOCAL_RANK`` modulo the
count). The backend is NCCL when each rank has a card of its own, and Gloo
on the CPU or when a node's ranks share a card (NCCL refuses two ranks on
one device; Gloo all-reduces CUDA tensors through the host). Rank 0 prints
the choice. A launcher that says world size 1 gets a group of one, so the
step's collectives run as they would at any size.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_KEYS = ("coordinator_address", "num_processes", "process_id")
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _given(v) -> bool:
    return v is not None and v != ""


def launch_settings(config: dict | None = None) -> dict | None:
    """The process grid a launcher or the config asks for: {address, world,
    rank, local_rank, local_world}, or None when nothing asks for one.
    Raises on a half-configured launcher: falling back to one process would
    start N independent runs, each training on its row block alone."""
    cfg = config or {}
    keys = [cfg.get(k) for k in _KEYS]
    env = [os.environ.get(k) for k in _ENV]
    if any(_given(v) for v in keys):
        if not all(_given(v) for v in keys):
            raise RuntimeError(
                "incomplete distributed settings: coordinator_address="
                f"{keys[0]!r}, num_processes={keys[1]!r}, process_id={keys[2]!r}; set all three "
                "or none")
        world, rank = int(keys[1]), int(keys[2])
        return {"address": str(keys[0]), "world": world, "rank": rank, "local_rank": rank,
                "local_world": world}
    if any(_given(v) for v in env):
        if not all(_given(v) for v in env):
            raise RuntimeError(
                "incomplete distributed settings: "
                + ", ".join(f"{k}={v!r}" for k, v in zip(_ENV, env))
                + "; set all four (python -m torch.distributed.run does) or none")
        world, rank = int(env[2]), int(env[3])
        return {"address": f"{env[0]}:{env[1]}", "world": world, "rank": rank,
                "local_rank": int(os.environ.get("LOCAL_RANK", rank)),
                "local_world": int(os.environ.get("LOCAL_WORLD_SIZE", world))}
    return None


def rank_device(device: str | torch.device | None = "cuda",
                local_rank: int | None = None) -> torch.device:
    """This rank's device: the CPU where the caller asks for it, else
    ``cuda:LOCAL_RANK`` (modulo the node's cards)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the ranks on the CPU")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> tuple[str, str]:
    """(backend, why) for ranks on ``device``, ``local_world`` of them on
    this node."""
    if device.type != "cuda":
        return "gloo", "the ranks run on the CPU"
    cards = torch.cuda.device_count()
    if local_world > cards:
        return "gloo", (f"{local_world} ranks share {cards} card(s) of this node; NCCL takes "
                        "one rank a card")
    return "nccl", "each rank has a card of its own"


def initialize(config: dict | None = None,
               device: str | torch.device | None = "cuda") -> tuple[int, int]:
    """Join the process group the config or the launcher asks for (see
    ``launch_settings``); a no-op for a single-process run or a group that
    exists already. Returns (process_index, process_count)."""
    if dist.is_initialized():
        return process_info()
    s = launch_settings(config)
    if s is None:
        return 0, 1
    dev = rank_device(device, s["local_rank"])
    backend, why = choose_backend(dev, s["local_world"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{s['address']}",
                            world_size=s["world"], rank=s["rank"])
    if s["rank"] == 0:
        print(f"Distributed backend: {backend} ({why}), {s['world']} process(es)", flush=True)
    return process_info()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return process_info()[0] == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if process_info()[1] > 1:
        dist.barrier()


def local_batch_slice(global_batch_size: int, pi: int | None = None,
                      pc: int | None = None) -> slice:
    """Rows of each global batch this process decodes: the contiguous block
    [pi*local, (pi+1)*local)."""
    if pi is None or pc is None:
        pi, pc = process_info()
    if global_batch_size % pc != 0:
        raise ValueError(
            f"global batch size {global_batch_size} is not divisible by process count {pc}")
    local = global_batch_size // pc
    return slice(pi * local, (pi + 1) * local)
