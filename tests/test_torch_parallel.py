"""Data parallelism of the port (kurosiwo_torch.parallel) on the CPU: 2 and 4
Gloo ranks (tests/torch_dist_worker.py), each on its row block of the global
batch, against the port's one process on the global batch and the JAX
package's step on the conftest's 8-device mesh (JAX's GSPMD over the global
batch).

Scenarios, each from the same seeded inputs and weights:
  * one UNet-ResNet18 SGD train step and one eval step (two padded rows) for
    every loss of ``create_loss``, one with the augmentations on, and one
    Siam-diff change-detection step (its Dropout2d masks drawn for the
    global batch);
  * training-mode BatchNorm: the statistics, y, dx and the scale and bias
    gradients;
  * one MAE step (accum 2) and one DDPM step;
  * the loaders' process grid (no ranks needed: a Loader takes its process
    index and count), against the JAX Loader's.

Bands (C5): ranks against one process are ulp-banded (the same values summed
in another order: the all-reduce's, the BatchNorm sums', the loss's); every
rank's loss is the same number, bitwise; the banks are exact counts. The
port against JAX's 8-device step is cross-framework: loss rtol 1e-4, each
bank cell within 0.1% of the valid pixels (near-tie argmax flips), the SGD
parameters within atol 1e-4 (lr 1e-2 times a gradient gap of 1e-2: the ReLU
near-ties of tests/torch_step_parity.py move single tensors' small
gradients; seen up to 2e-5) and the update within 2% in L2 norm, the running
statistics atol 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.data.pipeline import Loader as TLoader
from kurosiwo_torch.models.factory import initialize_cd_model as t_init_cd
from kurosiwo_torch.parallel import distributed as tdist
from kurosiwo_torch.parallel.mesh import MeshPlan, create_mesh, draw_rows, use_grid
from kurosiwo_torch.parallel.mesh import shard_batch as t_shard_batch
from kurosiwo_tpu.data.pipeline import Loader as JLoader
from kurosiwo_tpu.models.factory import initialize_segmentation_model as j_init_model
from kurosiwo_tpu.ops.losses import create_loss as j_create_loss
from kurosiwo_tpu.ops.metrics import MetricState as JMetricState
from kurosiwo_tpu.ops import pallas_bn
from kurosiwo_tpu.parallel.mesh import batch_sharding, replicated, shard_batch
from kurosiwo_tpu.parallel.mesh import create_mesh as j_create_mesh
from kurosiwo_tpu.training.state import create_train_state as j_create_state
from kurosiwo_tpu.training.steps import make_train_step as j_train_step
from torch_cd_parity import FAST_COMPILE, jit_fast
from torch_dist_worker import run, spawn

CW = [0.3715753140309927, 14.009780283125977, 8.20405370357821]
CFG = {
    "task": "segmentation", "method": "unet", "num_classes": 3,
    "inputs": ["pre_event_1", "pre_event_2", "post_event"], "channels": ["vv", "vh"],
    "num_channels": 6, "class_weights": CW, "weighted": True, "loss_function": "cross_entropy",
    "batch_size": 8, "mixed_precision": False, "dem": False, "fused_tail": False,
}
MCFG = {"backbone": "resnet18", "learning_rate": 1e-2}
LR = 1e-2
B, SIDE = 8, 32
AUGMENT = {"data_augmentations": True, "augmentations": {
    "RandomResizedCrop": {"value": SIDE, "scale": [0.5, 1.0], "p": 0.5},
    "HorizontalFlip": {"p": 0.5}, "VerticalFlip": {"p": 0.5}, "GaussNoise": {"p": 0.5},
    "MultNoise": {"p": 0.5}, "Cutout": {"p": 0.5}, "GaussianBlur": {"p": 0.5}}}
LOSSES = ("cross_entropy", "dice", "focal", "iou", "ce+dice")
CASES = LOSSES + ("augment", "siam-diff dropout")
MAE_CONFIG = {"image_size": 32, "patch_size": 8, "dim": 32, "depth": 1, "heads": 2,
              "mlp_dim": 32, "decoder_dim": 32, "decoder_depth": 1, "decoder_heads": 2,
              "masked_ratio": 0.75}
DIFFUSION_CONFIG = {"learning_rate": 1e-3, "dim": 8, "dim_mults": [1, 2], "timesteps": 10}


def _batch(seed: int, channels: int = 2, sample_weight=None, side: int = SIDE) -> dict:
    rs = np.random.RandomState(seed)
    b = {k: rs.randn(B, side, side, channels).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["mask"] = rs.randint(0, 4, (B, side, side)).astype(np.int32)
    b["valid"] = np.ones((B, side, side), np.int32)
    b["clz"] = np.ones((B,), np.int32)
    b["activation"] = np.ones((B,), np.int32)
    b["sample_weight"] = np.ones((B,), np.float32)
    if sample_weight is not None:
        b["sample_weight"] = np.asarray(sample_weight, np.float32)
        b["mask"][b["sample_weight"] == 0] = 3  # the loader's padding rows
    return b


def _numpy_tree(x):
    return jax.tree.map(np.asarray, dict(x))


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's UNet init, and its SGD train step with cross entropy on the
    8-device data mesh, the global batch sharded over it."""
    import optax

    cfg = dict(CFG)
    model = j_init_model(cfg, MCFG)
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=LR)
    x0 = jnp.zeros((2, SIDE, SIDE, 6), jnp.float32)
    state, _ = jit_fast(lambda key: j_create_state(model, tx, key, (x0,)), jax.random.PRNGKey(0))
    init = {"params": _numpy_tree(state.params), "batch_stats": _numpy_tree(state.batch_stats)}
    plan = j_create_mesh(num_data=8)
    bsh, rep = batch_sharding(plan), replicated(plan)
    step = jax.jit(j_train_step(model, tx, j_create_loss(cfg, "train"), cfg, MCFG, "segmentation"),
                   in_shardings=(rep, bsh, rep, rep, rep), out_shardings=(rep, rep, rep))
    args = (state, shard_batch(plan, jax.tree.map(jnp.asarray, _batch(0))),
            JMetricState.create(), jnp.asarray(LR, jnp.float32), jax.random.PRNGKey(1))
    new, ms, loss = step.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    return {"init": init, "loss": float(loss), "cm": np.asarray(ms.cm),
            "params": _numpy_tree(new.params), "batch_stats": _numpy_tree(new.batch_stats)}


def _state_dict_numpy(tree) -> dict:
    return {k: v.numpy() for k, v in flax_to_torch(tree).items()}


@pytest.fixture(scope="module")
def job(jax_ref):
    unet_init = _state_dict_numpy(jax_ref["init"])
    cases = {}
    for name in CASES:
        if name == "siam-diff dropout":
            cfg = {"task": "cd", "method": "siam-diff", "num_classes": 3, "num_channels": 2,
                   "mixed_precision": False, "batch_size": B, "remat": False,
                   "inputs": ["pre_event_1", "post_event"], "dem": False, "class_weights": CW,
                   "loss_function": "cross_entropy"}
            init = {k: v.numpy() for k, v in
                    t_init_cd(cfg, {}, "train", device="cpu", seed=0).state_dict().items()}
            cases[name] = {"config": cfg, "model_config": {}, "init": init,
                           "batch": _batch(0, side=36),
                           "eval_batch": _batch(1, sample_weight=[1] * 6 + [0] * 2, side=36)}
            continue
        cfg = dict(CFG, **(AUGMENT if name == "augment" else {"loss_function": name}))
        cases[name] = {"config": cfg, "model_config": MCFG, "init": unet_init, "batch": _batch(0),
                       "eval_batch": _batch(1, sample_weight=[1] * 6 + [0] * 2)}
    rs = np.random.RandomState(7)
    x = rs.randn(B, 4, 4, 16).astype(np.float32) * 2 + 1
    # 12 samples a split: one train batch, and val and test batches of 8 + 4
    engine_cfg = dict(_loader_config(synthetic_size=12, synthetic_patch_size=SIDE), **CFG,
                      track="RandomEvents", epochs=1, print_frequency=1, log_AOI_metrics=True,
                      val_acts=[514, 521], test_acts=[321, 322])
    return {
        "engine": {"config": engine_cfg, "model_config": MCFG, "init": unet_init},
        "unet": {"lr": LR, "cases": cases},
        "bn": {"x": x, "dy": rs.randn(*x.shape).astype(np.float32),
               "scale": (rs.rand(16) + 0.5).astype(np.float32),
               "bias": rs.randn(16).astype(np.float32)},
        "mae": {"lr": 1e-2, "model_config": MAE_CONFIG,
                "image": rs.randn(B, 32, 32, 6).astype(np.float32)},
        "diffusion": {"lr": 1e-2, "model_config": DIFFUSION_CONFIG,
                      "image": rs.randn(B, 16, 16, 2).astype(np.float32)},
    }


@pytest.fixture(scope="module")
def single(job, tmp_path_factory):
    """The one-process runs, in a directory of their own (the engine writes
    its checkpoints under the working directory)."""
    threads, cwd = torch.get_num_threads(), os.getcwd()
    torch.set_num_threads(1)
    os.chdir(tmp_path_factory.mktemp("one_process"))
    try:
        return run(job)
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request, job):
    return request.param, spawn(request.param, {k: v for k, v in job.items() if k != "engine"})


@pytest.fixture(scope="module")
def engine_ranks(job):
    """The engine epoch at 2 ranks alone (its loaders' decode processes make
    it the dearest scenario to spawn)."""
    return spawn(2, {"engine": job["engine"]})


def _close_states(got: dict, want: dict, atol: float) -> None:
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_dp_step_equals_one_process_on_the_global_batch(ranks, single, case):
    world, res = ranks
    ref = single["unet"][case]
    got = [r["unet"][case] for r in res]
    # every rank reports the same loss and banks, and holds the same state
    assert len({g["loss"] for g in got}) == 1 and len({g["eval_loss"] for g in got}) == 1
    for g in got[1:]:
        np.testing.assert_array_equal(g["cm"], got[0]["cm"])
        for k in g["state"]:
            np.testing.assert_array_equal(g["state"][k], got[0]["state"][k], err_msg=k)
    g = got[0]
    np.testing.assert_allclose(g["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_array_equal(g["cm"], ref["cm"])
    _close_states(g["state"], ref["state"], atol=1e-5)
    np.testing.assert_allclose(g["eval_loss"], ref["eval_loss"], rtol=1e-5)
    np.testing.assert_array_equal(g["eval_cm"], ref["eval_cm"])
    assert g["eval_count"] == ref["eval_count"] == 6.0
    np.testing.assert_allclose(g["eval_loss_sum"], ref["eval_loss_sum"], rtol=1e-5)


def _assert_cm_close(got, want) -> None:
    """Label counts equal, each cell within 0.1% of the valid pixels."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert np.abs(got - want).max() <= 1e-3 * want.sum()


def test_dp_step_matches_jax_on_the_8_device_mesh(ranks, single, jax_ref, job):
    """The cross-entropy step at 2 and 4 ranks (and one process) against
    JAX's under create_mesh(num_data=8)."""
    _, res = ranks
    for g in (res[0]["unet"]["cross_entropy"], single["unet"]["cross_entropy"]):
        np.testing.assert_allclose(g["loss"], jax_ref["loss"], rtol=1e-4)
        _assert_cm_close(g["cm"], jax_ref["cm"])
        tree = torch_to_flax({k: torch.from_numpy(v) for k, v in g["state"].items()})
        got_p, want_p = jax.tree.leaves(tree["params"]), jax.tree.leaves(jax_ref["params"])
        for got, want in zip(got_p, want_p):
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        # the SGD update, -lr times the gradient, within 2% in L2 norm
        init = jax.tree.leaves(jax_ref["init"]["params"])
        num = sum(float(np.square(g - w).sum()) for g, w in zip(got_p, want_p))
        den = sum(float(np.square(w - i).sum()) for w, i in zip(want_p, init))
        assert np.sqrt(num / den) <= 2e-2
        for got, want in zip(jax.tree.leaves(tree["batch_stats"]),
                             jax.tree.leaves(jax_ref["batch_stats"])):
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bn_statistics_and_gradients_are_the_global_batch(ranks, single, job):
    """Each rank's BatchNorm holds the global statistics, its rows of y and
    dx are the global ones, and its scale and bias gradients after the
    all-reduce are the global ones; the one-process port against JAX's
    pallas_bn (the Pallas pair sums in interpret mode) too."""
    _, res = ranks
    ref = single["bn"]
    for r in res:
        for k in ("mean", "var", "dscale", "dbias"):
            np.testing.assert_allclose(r["bn"][k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("y", "dx"):
        got = np.concatenate([r["bn"][k] for r in res])
        np.testing.assert_allclose(got, ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    bn = job["bn"]
    x, scale, bias = (jnp.asarray(bn[k]) for k in ("x", "scale", "bias"))

    def f(x, scale, bias):
        y, mean, var = pallas_bn.bn_train_apply(x, scale, bias, 1e-5, True)
        return jnp.sum(y * jnp.asarray(bn["dy"])), (y, mean, var)

    (_, (y, mean, var)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        x, scale, bias)
    for got, want in ((ref["y"], y), (ref["mean"], mean), (ref["var"], var), (ref["dx"], grads[0]),
                      (ref["dscale"], grads[1]), (ref["dbias"], grads[2])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scenario", ["mae", "diffusion"])
def test_mae_and_diffusion_steps_equal_one_process(ranks, single, scenario):
    """Both losses are means over per-sample terms of one size, so the mean
    of the ranks' losses and gradients is the global batch's."""
    _, res = ranks
    ref = single[scenario]
    assert len({r[scenario]["loss"] for r in res}) == 1
    np.testing.assert_allclose(res[0][scenario]["loss"], ref["loss"], rtol=1e-5)
    _close_states(res[0][scenario]["state"], ref["state"], atol=1e-5)


def test_engine_epoch_equals_one_process(engine_ranks, single):
    """train_task over the synthetic splits (the val and test splits' last
    batches hold 4 real rows of 8: rank 1's block is all padding and still
    steps) and the test eval at 2 ranks: every rank prints the global
    batch's numbers (the banks
    and the AOI banks reduced), rank 0 writes the checkpoints the one process
    writes, and every rank holds its state."""
    res = engine_ranks
    ref = single["engine"]
    for r in res[1:]:
        assert r["engine"]["test"] == res[0]["engine"]["test"]
        np.testing.assert_array_equal(r["engine"]["cm"], res[0]["engine"]["cm"])
        assert r["engine"]["aoi"] == res[0]["engine"]["aoi"]
        for k in ref["state"]:
            np.testing.assert_array_equal(r["engine"]["state"][k], res[0]["engine"]["state"][k])
    got = res[0]["engine"]
    assert got["files"] == ref["files"]
    assert {"best_segmentation.ptr.json", "latest.ptr.json"} <= set(ref["files"])
    # the engine's Adam: its first update is about lr * sign(g), so a gradient
    # near zero that the ranks' sums round to the other sign moves its
    # parameter by up to 2 lr (C6, tests/torch_step_parity.py), and a few
    # test pixels' argmax with it: the banks within 0.1% of the valid pixels
    assert len(ref["aoi"]) > 1 and got["aoi"].keys() == ref["aoi"].keys()
    for a in ref["aoi"]:
        _assert_cm_close(got["aoi"][a], ref["aoi"][a])
    _assert_cm_close(got["cm"], ref["cm"])
    np.testing.assert_allclose(got["test"], ref["test"], atol=0.1)  # points
    got, want = got["state"], ref["state"]
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert d.max() <= 2 * MCFG["learning_rate"] + 1e-6 and np.mean(d <= 3e-4) >= 0.99


# -- draws over the global batch -------------------------------------------------------

def test_draw_rows_cuts_the_global_draw():
    """A rank's draws are its rows of the one-process draw; tensors that
    are one object stay one."""
    from kurosiwo_torch.parallel.mesh import DataGrid

    def draw(n):
        g = torch.Generator().manual_seed(0)
        a = torch.rand((n, 3), generator=g)
        return {"a": a, "same": a, "b": [torch.randint(0, 9, (n,), generator=g)]}

    full = draw(8)
    for index in range(4):
        with use_grid(DataGrid(None, index, 4)):
            got = draw_rows(draw, 2)
        rows = slice(2 * index, 2 * index + 2)
        torch.testing.assert_close(got["a"], full["a"][rows], rtol=0, atol=0)
        torch.testing.assert_close(got["b"][0], full["b"][0][rows], rtol=0, atol=0)
        assert got["same"] is got["a"]
    assert draw_rows(draw, 8)["a"].shape == (8, 3)


# -- the loaders' process grid -----------------------------------------------------------

def _loader_config(**kw) -> dict:
    return {"task": "segmentation", "root_path": "/nonexistent-kuro-siwo", "batch_size": 16,
            "num_workers": 1, "synthetic_data": True, "synthetic_size": 32,
            "synthetic_patch_size": 16, "train_acts": [130, 470], "val_acts": [514],
            "test_acts": [321], "scale_input": "normalize", "clamp_input": 0.15,
            "data_mean": [0.0953, 0.0264], "data_std": [0.0427, 0.0215], "channels": ["vv", "vh"],
            "inputs": ["pre_event_1", "pre_event_2", "post_event"], "dem": False,
            "oversampling": False, **kw}


def _first(loader) -> dict:
    try:
        return next(iter(loader))
    finally:
        loader.close()


def _batches(loader) -> list:
    try:
        return list(loader)
    finally:
        loader.close()


def test_process_blocks_tile_the_global_batch():
    """Two process-sliced loaders give the one-process batch, block by block
    (the same seed draws the same epoch indices), as JAX's loaders do."""
    cfg = _loader_config()
    full = _first(TLoader("train", cfg, seed=5, process_index=0, process_count=1))
    p0 = _first(TLoader("train", cfg, seed=5, process_index=0, process_count=2))
    p1 = _first(TLoader("train", cfg, seed=5, process_index=1, process_count=2))
    j1 = next(iter(JLoader("train", cfg, seed=5, process_index=1, process_count=2)))
    for k in full:
        np.testing.assert_array_equal(np.concatenate([p0[k], p1[k]]), full[k], err_msg=k)
        np.testing.assert_array_equal(p1[k], j1[k], err_msg=k)


def test_eval_padding_of_a_process_block_matches_jax():
    """A ragged last val batch (20 = 16 + 4): process 1's block is all
    padding (zero samples of weight 0, mask 3) and still makes a batch;
    process 0's pads its 4 real rows with copies. Both bitwise JAX's."""
    cfg = _loader_config(synthetic_size=20)
    for pi in (0, 1):
        ours = _batches(TLoader("val", cfg, seed=5, process_index=pi, process_count=2))
        theirs = list(JLoader("val", cfg, seed=5, process_index=pi, process_count=2))
        assert len(ours) == len(theirs) == 2
        for a, b in zip(ours, theirs):
            assert a.keys() == b.keys() and a["mask"].shape[0] == 8
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{pi} {k}")
    last = ours[-1]
    assert float(last["sample_weight"].sum()) == 0.0 and (last["mask"] == 3).all()


def test_indivisible_global_batch_raises():
    with pytest.raises(ValueError, match="not divisible"):
        TLoader("train", _loader_config(batch_size=10), process_index=0, process_count=4)


# -- the launcher -------------------------------------------------------------------

def test_local_batch_slice_math():
    assert tdist.local_batch_slice(16, 0, 2) == slice(0, 8)
    assert tdist.local_batch_slice(16, 1, 2) == slice(8, 16)
    assert tdist.local_batch_slice(8, 3, 4) == slice(6, 8)
    with pytest.raises(ValueError):
        tdist.local_batch_slice(10, 0, 4)


@pytest.mark.parametrize("given", [
    {"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "2"},
    {"RANK": "1"},
    {"config": {"coordinator_address": "127.0.0.1:1234", "num_processes": 2}},
])
def test_half_configured_launcher_raises(monkeypatch, given):
    """As JAX's initialize: a partial setting must not fall back to N
    independent one-process runs."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    given = dict(given)
    config = given.pop("config", None)
    for k, v in given.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="incomplete distributed settings"):
        tdist.initialize(config, device="cpu")


def test_no_launcher_is_one_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize(device="cpu") == (0, 1) and tdist.process_info() == (0, 1)
    assert create_mesh() == MeshPlan() and MeshPlan().data_grid() is None
    local = t_shard_batch(MeshPlan(), {"mask": np.zeros((2, 4), np.int32)}, "cpu")
    assert local["mask"].shape == (2, 4) and local["mask"].device.type == "cpu"


def test_backend_choice():
    assert tdist.choose_backend(torch.device("cpu"), 4)[0] == "gloo"
    with pytest.raises(ValueError, match=r"mesh 3x1 != 1"):
        create_mesh(3)
