"""Gloo ranks for the port's data-, context- and tensor-parallel tests
(tests/test_torch_parallel.py, tests/test_torch_ring_attention.py,
tests/test_torch_tensor_parallel.py).

``spawn(world, job)`` starts ``world`` processes of this file on the CPU,
joined by ``kurosiwo_torch.parallel.initialize`` over Gloo on a free local
port. Each runs every scenario of ``job`` (a dict: scenario name -> its
inputs, numpy arrays and configs) on its rank's share and returns its
results; the tests run the same scenario functions in their own process
with no process group (``plan=None``) for the one-process reference on the
global batch. One thread a rank, as the reference sets it, so that the CPU
sums agree where the tests ask for bitwise equality.

A spawn has its own timeout and one retry on Gloo's rendezvous signature
alone (a loaded host can miss the connect window), as tests/test_multihost.py
does for the JAX package's ranks.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

RENDEZVOUS = ("Gloo connectFullMesh failed", "Connection refused", "Timed out", "timed out",
              "Address already in use")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, job: dict, timeout: float = 300.0) -> list[dict]:
    """Each rank's results of ``job`` at ``world`` Gloo ranks."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    with tempfile.TemporaryDirectory() as tmp:
        jobfile = Path(tmp) / "job.pkl"
        jobfile.write_bytes(pickle.dumps(job))
        for attempt in range(2):
            port = free_port()
            procs = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(world), str(rank), str(port),
                 str(jobfile), tmp], env=env, cwd=tmp, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for rank in range(world)]
            outs = []
            try:
                for p in procs:
                    outs.append(p.communicate(timeout=timeout)[0])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if all(p.returncode == 0 for p in procs):
                return [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes())
                        for r in range(world)]
            flake = any(sig in out for out in outs for sig in RENDEZVOUS)
            if attempt == 1 or not flake:
                raise AssertionError("\n".join(f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
                                               for r, (p, out) in enumerate(zip(procs, outs))))
    raise AssertionError("unreachable")


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: a model's tensors are loaded anew for the next case."""
    return np.array(t.detach().float().cpu() if t.dtype == torch.bfloat16 else t.detach().cpu())


def _rows(plan, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` (all without a plan)."""
    if plan is None:
        return slice(0, n)
    local = n // plan.num_data
    return slice(plan.data_index * local, (plan.data_index + 1) * local)


def _state(model: torch.nn.Module) -> dict:
    return {k: _np(v) for k, v in model.state_dict().items()}


# -- the scenarios ------------------------------------------------------------------

def unet_steps(job: dict, plan) -> dict:
    """One SGD train step and one eval step of each case's config, from the
    job's weights, on this rank's rows of the global batches: the loss, the
    reduced banks, the parameters and statistics after the step."""
    from kurosiwo_torch.models.factory import initialize_cd_model, initialize_segmentation_model
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.state import TrainState
    from kurosiwo_torch.training.steps import make_eval_step, make_train_step

    out, models = {}, {}
    for name, case in job["cases"].items():
        cfg, mcfg = case["config"], case["model_config"]
        task = cfg.get("task", "segmentation")
        # one model a method, its weights loaded anew for each case
        if cfg["method"] not in models:
            models[cfg["method"]] = (
                initialize_cd_model(cfg, mcfg, "train", device="cpu", seed=0) if task == "cd"
                else initialize_segmentation_model(cfg, mcfg, device="cpu"))
        model = models[cfg["method"]]
        model.load_state_dict({k: torch.from_numpy(v) for k, v in case["init"].items()})
        state = TrainState(0, model, torch.optim.SGD(model.parameters(), lr=job["lr"]))
        step = make_train_step(model, create_loss(cfg, "train"), cfg, mcfg, task, device="cpu",
                               plan=plan)
        batch = {k: v[_rows(plan, len(v))] for k, v in case["batch"].items()}
        g = torch.Generator().manual_seed(5)
        state, ms, loss = step(state, batch, MetricState.create(), job["lr"], g)
        grid = None if plan is None else plan.data_grid()
        res = {"loss": float(loss), "cm": _np(ms.reduce(grid).cm), "state": _state(model)}
        ev = make_eval_step(model, create_loss(cfg, "val"), cfg, mcfg, task, device="cpu",
                            plan=plan)
        eval_batch = {k: v[_rows(plan, len(v))] for k, v in case["eval_batch"].items()}
        ems, eloss, _ = ev(state, eval_batch, MetricState.create())
        ems = ems.reduce(grid)
        res.update(eval_loss=float(eloss), eval_cm=_np(ems.cm), eval_count=float(ems.count),
                   eval_loss_sum=float(ems.loss_sum))
        out[name] = res
    return out


def bn_stats(job: dict, plan) -> dict:
    """Training-mode BatchNorm on this rank's rows: the statistics, the
    output rows, dx rows and the scale and bias gradients after the
    gradient all-reduce."""
    from kurosiwo_torch.ops.batchnorm import bn_train_apply
    from kurosiwo_torch.parallel.mesh import sync_gradients, use_grid

    rows = _rows(plan, len(job["x"]))
    x = torch.from_numpy(job["x"][rows]).requires_grad_(True)
    scale = torch.from_numpy(job["scale"]).requires_grad_(True)
    bias = torch.from_numpy(job["bias"]).requires_grad_(True)
    grid = None if plan is None else plan.data_grid()
    with use_grid(grid):
        y, mean, var = bn_train_apply(x, scale, bias)
        (y * torch.from_numpy(job["dy"][rows])).sum().backward()
    holder = torch.nn.ParameterList([torch.nn.Parameter(scale.detach()),
                                     torch.nn.Parameter(bias.detach())])
    holder[0].grad, holder[1].grad = scale.grad, bias.grad
    sync_gradients(holder.parameters(), grid)
    return {"y": _np(y), "mean": _np(mean), "var": _np(var), "dx": _np(x.grad),
            "dscale": _np(holder[0].grad), "dbias": _np(holder[1].grad)}


def ring(job: dict, plan) -> dict:
    """Ring attention on this rank's sequence shard of each case: the output
    shard and the gradients of sum((out - t)^2) for its q, k, v shards."""
    from kurosiwo_torch.ops.ring_attention import ring_attention

    out = {}
    for name, case in job["cases"].items():
        n, p = case["q"].shape[2], (1 if plan is None else plan.num_model)
        idx = 0 if plan is None else plan.model_index
        rows = slice(idx * n // p, (idx + 1) * n // p)
        q, k, v = (torch.from_numpy(case[x][:, :, rows]).requires_grad_(True) for x in "qkv")
        if plan is None:
            from kurosiwo_torch.parallel.mesh import MeshPlan

            plan_ = MeshPlan()
        else:
            plan_ = plan
        o = ring_attention(q, k, v, plan_)
        ((o - torch.from_numpy(case["t"][:, :, rows])) ** 2).sum().backward()
        out[name] = {"out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad)}
    return out


def cp_encode(job: dict, plan) -> dict:
    """``vit_whole_scene_cp`` of the job's scene with the job's encoder."""
    from kurosiwo_torch.inference import vit_whole_scene_cp
    from kurosiwo_torch.models.vit import ViT
    from kurosiwo_torch.parallel.mesh import MeshPlan

    vit = ViT(**job["vit"])
    vit.load_state_dict({k: torch.from_numpy(v) for k, v in job["weights"].items()})
    tokens = vit_whole_scene_cp(vit, job["scene"], plan or MeshPlan(), dtype=torch.float32,
                                device="cpu")
    return {"tokens": _np(tokens)}


def mae_step(job: dict, plan) -> dict:
    """One SGD step of the MAE train step (accum 2) on this rank's rows."""
    from kurosiwo_torch.models.factory import build_mae
    from kurosiwo_torch.training.mae import make_mae_train_step
    from kurosiwo_torch.training.state import TrainState

    model = build_mae({"num_channels": 6, "mixed_precision": False}, job["model_config"],
                      device="cpu", seed=0)
    state = TrainState(0, model, torch.optim.SGD(model.parameters(), lr=job["lr"]))
    step = make_mae_train_step(model, accum=2, device="cpu", plan=plan)
    images = job["image"][_rows(plan, len(job["image"]))]
    state, loss = step(state, {"image": images}, job["lr"], torch.Generator().manual_seed(3))
    return {"loss": float(loss), "state": _state(model)}


def diffusion_step(job: dict, plan) -> dict:
    """One SGD step of the DDPM train step on this rank's rows."""
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.training.diffusion import make_diffusion_train_step
    from kurosiwo_torch.training.state import TrainState

    model = initialize_segmentation_model({"task": "diffusion-unsup", "method": "diffusion"},
                                          job["model_config"], device="cpu", seed=0)
    state = TrainState(0, model, torch.optim.SGD(model.parameters(), lr=job["lr"]))
    step = make_diffusion_train_step(model, "cpu", plan)
    images = job["image"][_rows(plan, len(job["image"]))]
    state, loss = step(state, {"image": images}, torch.Generator().manual_seed(4))
    return {"loss": float(loss), "state": _state(model)}


def engine_epoch(job: dict, plan) -> dict:
    """``train_task`` for one epoch over the job's synthetic splits (this
    rank's row blocks; the last val and test batches hold 4 real rows of 8,
    so that at 2 ranks rank 1's block is all padding), then the test eval:
    the summaries, the checkpoint files (rank 0 writes them under the
    working directory) and the final state."""
    from kurosiwo_torch.data.pipeline import prepare_loaders
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.training.engine import train_task

    cfg = dict(job["config"], checkpoint_path=str(Path.cwd() / "engine"))
    model = initialize_segmentation_model(cfg, job["model_config"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job["init"].items()})
    loaders = prepare_loaders(cfg, seed=3)
    try:
        engine = train_task(model, *loaders, cfg, job["model_config"], "segmentation",
                            device="cpu", seed=3, plan=plan)
        acc, f1, miou, summary = engine.run_eval(loaders[2], "Test")
    finally:
        for loader in loaders:
            loader.close()
    return {"test": (acc, f1, miou), "cm": summary["cm"],
            "aoi": {a: cm.tolist() for a, cm in summary["aoi_banks"].items()},
            "files": sorted(f.name for f in (Path.cwd() / "engine").iterdir()),
            "state": _state(engine.model)}


def tp_vit(job: dict, plan) -> dict:
    """The ViT forward on this rank's rows, its parameters cut by JAX's rule
    at the job's ``min_size`` over the plan's model axis: the output rows,
    the cuts (dim, layout, whole shape) and the cut parameters' slices;
    then ``vit_whole_scene_cp``'s refusal of the cut encoder."""
    from kurosiwo_torch.inference import vit_whole_scene_cp
    from kurosiwo_torch.models.vit import ViT
    from kurosiwo_torch.parallel.sharding import apply_shardings

    vit = ViT(**job["vit"])
    vit.load_state_dict({k: torch.from_numpy(v) for k, v in job["weights"].items()})
    cuts = apply_shardings(plan, vit, min_size=job["min_size"]) if plan is not None else {}
    x = torch.from_numpy(job["x"][_rows(plan, len(job["x"]))])
    with torch.no_grad():
        out = vit(x, torch.float32)
    res = {"out": _np(out), "cuts": {n: (s.dim, s.layout, s.full) for n, s in cuts.items()},
           "slices": {n: _np(p) for n, p in vit.named_parameters() if n in cuts}}
    if plan is not None:
        try:
            vit_whole_scene_cp(vit, job["scene"], plan, dtype=torch.float32, device="cpu")
            res["cp_refusal"] = None
        except ValueError as e:
            res["cp_refusal"] = str(e)
    return res


def tp_unet(job: dict, plan) -> dict:
    """One SGD train step of the UNet on this rank's rows, its parameters
    cut by JAX's rule over the plan's model axis: the loss, the reduced
    bank, the gathered state, the gradients of the uncut parameters, the
    B3 call widths, a checkpoint written under the cut (rank 0 writes,
    every rank gathers) read back into a whole model; then one Adam step
    from the job's weights, cut the same way, and its gathered moments."""
    from kurosiwo_torch.models.factory import initialize_segmentation_model
    from kurosiwo_torch.ops import batchnorm
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.parallel.sharding import apply_shardings, gather_state
    from kurosiwo_torch.training.checkpoint import CheckpointManager
    from kurosiwo_torch.training.state import TrainState
    from kurosiwo_torch.training.steps import make_train_step

    cfg, mcfg = job["config"], job["model_config"]
    model = initialize_segmentation_model(cfg, mcfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job["init"].items()})
    cuts = apply_shardings(plan, model, min_size=job["min_size"]) if plan is not None else {}
    state = TrainState(0, model, torch.optim.SGD(model.parameters(), lr=job["lr"]))
    step = make_train_step(model, create_loss(cfg, "train"), cfg, mcfg, "segmentation",
                           device="cpu", plan=plan)
    batch = {k: v[_rows(plan, len(v))] for k, v in job["batch"].items()}
    widths = []
    plain = batchnorm.pair_sums_plain

    def record(a, b):
        widths.append(a.shape[-1])
        return plain(a, b)

    batchnorm.pair_sums_plain = record
    try:
        state, ms, loss = step(state, batch, MetricState.create(), job["lr"])
    finally:
        batchnorm.pair_sums_plain = plain
    grid = None if plan is None else plan.data_grid()
    whole, _ = gather_state(model)
    res = {"loss": float(loss), "cm": _np(ms.reduce(grid).cm),
           "state": {k: _np(v) for k, v in whole.items()},
           "grads": {n: _np(p.grad) for n, p in model.named_parameters() if n not in cuts},
           "cut": sorted(cuts), "bn_widths": widths}
    manager = CheckpointManager(Path.cwd() / "tp")
    manager.save("latest", state)
    one = initialize_segmentation_model(cfg, mcfg, device="cpu")
    one.load_state_dict(manager.load("latest")[0]["model"])
    res["checkpoint"] = _state(one)
    # Adam from the job's weights: its moments made on the slices
    model = initialize_segmentation_model(cfg, mcfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job["init"].items()})
    adam = torch.optim.Adam(model.parameters(), lr=1e-3)
    if plan is not None:
        apply_shardings(plan, model, adam, min_size=job["min_size"])
    step = make_train_step(model, create_loss(cfg, "train"), cfg, mcfg, "segmentation",
                           device="cpu", plan=plan)
    step(TrainState(0, model, adam), batch, MetricState.create(), job["lr"])
    _, opt = gather_state(model, adam)
    names = [n for n, _ in model.named_parameters()]
    res["adam"] = {names[i]: {k: _np(v) for k, v in s.items() if k != "step"}
                   for i, s in opt["state"].items()}
    return res


def tp_models(job: dict, plan) -> dict:
    """Two more models cut by JAX's rule at the job's ``min_size``, each on
    the whole batch on every rank: the MAE's loss from the job's noise and
    its gradients (a cut one gathered whole), whose encoder's and decoder's
    positions are read across modules; BiT-CD's eval forward, whose
    ``pos_embedding`` lives in a module with no sliced forward (it gets the
    parameter whole for its forward)."""
    from kurosiwo_torch.models.bit_cd import build_bit_cd
    from kurosiwo_torch.models.factory import build_mae
    from kurosiwo_torch.parallel.mesh import shard_of
    from kurosiwo_torch.parallel.sharding import apply_shardings

    mae = build_mae({"num_channels": 6, "mixed_precision": False}, job["mae_config"],
                    device="cpu", seed=0)
    bit = build_bit_cd({"net_G": "base_transformer_pos_s4"}, 2,
                       generator=torch.Generator().manual_seed(0)).eval()
    cuts = {}
    if plan is not None:
        cuts = {name: sorted(apply_shardings(plan, m, min_size=job["min_size"]))
                for name, m in (("mae", mae), ("bit", bit))}
    loss = mae(torch.from_numpy(job["image"]), torch.from_numpy(job["noise"]))
    loss.backward()
    grads = {}
    for prefix, m in mae.named_modules():
        for n, p in m.named_parameters(recurse=False):
            if p.grad is None:  # the encoder's cls token: MAE does not read it
                continue
            shard = shard_of(m, n)
            g = p.grad if shard is None else shard.gather(p.grad)
            grads[f"{prefix}.{n}" if prefix else n] = _np(g)
    with torch.no_grad():
        out = bit(*(torch.from_numpy(x) for x in job["frames"]))
    return {"mae_loss": float(loss), "mae_grads": grads, "bit": _np(out), "cuts": cuts}


# scenario -> (function, the plan's axis: "data" shards the batch, "model" the
# sequence, "data x model" the batch over half the ranks and the parameters
# over pairs)
SCENARIOS = {"unet": (unet_steps, "data"), "bn": (bn_stats, "data"), "ring": (ring, "model"),
             "cp": (cp_encode, "model"), "mae": (mae_step, "data"),
             "diffusion": (diffusion_step, "data"), "engine": (engine_epoch, "data"),
             "tp_vit": (tp_vit, "data x model"), "tp_unet": (tp_unet, "data x model"),
             "tp_models": (tp_models, "data x model")}


def run(job: dict, world: int = 1) -> dict:
    """Every scenario of ``job`` on a plan of this process's group over the
    scenario's axis (one process, no group: ``plan=None``)."""
    from kurosiwo_torch.parallel import create_mesh

    plans = {}
    out = {}
    for name, scenario in job.items():
        fn, axis = SCENARIOS[name]
        if world > 1 and axis not in plans:
            plans[axis] = {"data": (world, 1), "model": (1, world),
                           "data x model": (world // 2, 2)}[axis]
            plans[axis] = create_mesh(*plans[axis])
        out[name] = fn(scenario, plans.get(axis))
    return out


def main(argv: list[str]) -> None:
    world, rank, port, jobfile, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    torch.set_num_threads(1)
    from kurosiwo_torch.parallel import initialize
    from kurosiwo_torch.parallel.distributed import shutdown

    initialize({"coordinator_address": f"127.0.0.1:{port}", "num_processes": world,
                "process_id": rank}, device="cpu")
    try:
        results = run(pickle.loads(Path(jobfile).read_bytes()), world)
        (Path(outdir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    finally:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
