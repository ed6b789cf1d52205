"""The multi-process dry run on the CPU; counterpart of
``__graft_entry__._dryrun_multichip_body``.

    python -m kurosiwo_torch.parallel.dryrun --ranks N

starts N Gloo ranks of this module on the CPU (a free local port), joined
as a DP(N/2) x TP(2) grid (N odd: DP(N) x TP(1)). Each rank runs one Adam
train step of the dry run's UNet-ResNet18 (f32, 2 channels, 64 x 64, a
global batch of 2 per data rank, JAX's sharding rule at ``min_size``
1 << 12) on its rows, then ring attention over all N ranks on a
(1, 2, 8 N, 16) sequence. Rank 0 prints one line with the loss; the
command exits 0 when every rank did.
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys

import numpy as np
import torch

CONFIG = {
    "task": "segmentation", "method": "unet", "num_classes": 3, "mixed_precision": False,
    "num_channels": 2, "inputs": ["post_event"], "channels": ["vv", "vh"], "dem": False,
    "weighted": True, "class_weights": [0.3716, 14.0098, 8.2041],
    "loss_function": "cross_entropy", "log_zone_metrics": False, "log_AOI_metrics": False,
}
MODEL_CONFIG = {"backbone": "resnet18", "learning_rate": 1e-3, "optimizer": "adam"}
SIZE = 64
MIN_SIZE = 1 << 12


def rank_body(ranks: int) -> str:
    """One rank's dry run in the joined process group; the summary line."""
    from ..models.factory import initialize_segmentation_model
    from ..ops.losses import create_loss
    from ..ops.metrics import MetricState
    from ..ops.ring_attention import ring_attention
    from ..training.state import create_train_state
    from ..training.steps import make_train_step
    from .distributed import local_batch_slice
    from .mesh import create_mesh
    from .sharding import apply_shardings

    num_model = 2 if ranks % 2 == 0 else 1
    plan = create_mesh(ranks // num_model, num_model)
    cfg = dict(CONFIG, batch_size=2 * plan.num_data)
    model = initialize_segmentation_model(cfg, MODEL_CONFIG, device="cpu")
    state = create_train_state(model, cfg, MODEL_CONFIG)
    cuts = apply_shardings(plan, model, state.optimizer, min_size=MIN_SIZE)
    step = make_train_step(model, create_loss(cfg, "train"), cfg, MODEL_CONFIG,
                           device="cpu", plan=plan)
    batch_size = cfg["batch_size"]
    rs = np.random.RandomState(0)
    batch = {
        "post": rs.randn(batch_size, SIZE, SIZE, 2).astype(np.float32),
        "pre1": rs.randn(batch_size, SIZE, SIZE, 2).astype(np.float32),
        "pre2": rs.randn(batch_size, SIZE, SIZE, 2).astype(np.float32),
        "mask": rs.randint(0, 4, (batch_size, SIZE, SIZE)).astype(np.int32),
        "clz": rs.randint(1, 4, (batch_size,)).astype(np.int32),
        "activation": np.full((batch_size,), 130, np.int32),
        "sample_weight": np.ones((batch_size,), np.float32),
    }
    rows = local_batch_slice(batch_size, plan.data_index, plan.num_data)
    state, _, loss = step(state, {k: v[rows] for k, v in batch.items()}, MetricState.create(),
                          1e-3)
    if not np.isfinite(float(loss)):
        raise RuntimeError("dry-run loss is not finite")

    seq = create_mesh(1, ranks)
    qkv = torch.randn((3, 1, 2, 8 * ranks, 16), generator=torch.Generator().manual_seed(0))
    shard = slice(seq.model_index * 8, (seq.model_index + 1) * 8)
    out = ring_attention(*(t[:, :, shard] for t in qkv), seq)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("ring attention produced non-finite values")
    return (f"dryrun OK: grid ({plan.num_data}, {plan.num_model}) (dp x tp), batch {batch_size}, "
            f"{len(cuts)} parameters cut, loss {float(loss):.4f}; ring attention (sp) over "
            f"{ranks} ranks OK")


def _rank_main(ranks: int, rank: int, port: int) -> int:
    from .distributed import initialize, shutdown

    torch.set_num_threads(1)
    initialize({"coordinator_address": f"127.0.0.1:{port}", "num_processes": ranks,
                "process_id": rank}, device="cpu")
    try:
        line = rank_body(ranks)
    finally:
        shutdown()
    if rank == 0:
        print(line, flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="DP x TP dry run of the port on CPU Gloo ranks")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.ranks, args.rank, args.port)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-m", "kurosiwo_torch.parallel.dryrun",
                               "--ranks", str(args.ranks), "--rank", str(r), "--port", str(port)])
             for r in range(args.ranks)]
    try:
        rcs = [p.wait(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        print(f"dryrun FAILED: rank exit codes {rcs}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
