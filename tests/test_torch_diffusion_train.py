"""The port's diffusion task end to end against the JAX package's, on the
CPU at a tiny size (dim 8, dim_mults (1, 2), 10 timesteps, 32x32): the
per-observation loader (synthetic and from a packed split, train and a
padded eval), ``training/diffusion.train`` against JAX's ``train()`` from
JAX's initial weights with JAX's timesteps and noise fed to the port (C15's
rule), and ``python -m kurosiwo_torch --method diffusion``.

Exactness classes (ROADMAP C5):
- bit-exact: every key of every batch of the loader (numpy on both sides);
  the checkpoint names; the printed losses' count and format;
- cross-framework banded, f32: the two steps' losses within 2e-5 of JAX's
  (JAX prints 5 decimals); Adam's parameters after them as the MAE loop's
  test holds them (C6: the first step flips sign at near-ties): all within
  2 x the summed lr of JAX's, 99% within 0.3 x.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.data import shards as tshards
from kurosiwo_torch.data.pipeline import Loader as TLoader
from kurosiwo_torch.training import diffusion as t_diff
from kurosiwo_torch.training.checkpoint import CheckpointManager as TCheckpoints
from kurosiwo_tpu.data.pipeline import Loader as JLoader
from kurosiwo_tpu.training import diffusion as j_diff
from torch_cd_parity import FastInit, FastJax

torch.set_num_threads(2)

MCFG = {"learning_rate": 1e-3, "dim": 8, "dim_mults": [1, 2], "timesteps": 10}
SIDE = 32


def _cfg(base_config, **kw):
    # 5 patches -> 15 typed records: train 3 batches of 4 (drops 3), eval 4 (pads 1)
    return {**base_config, "task": "diffusion-unsup", "method": "diffusion", "batch_size": 4,
            "synthetic_size": 5, "synthetic_patch_size": SIDE, "num_workers": 2, **kw}


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["activation", "clz", "image", "sample_weight"]
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("packed", [False, True], ids=["synthetic", "packed"])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_loader_batches_are_the_jax_loaders(base_config, tmp_path, mode, packed):
    """Two epochs of typed batches: pre1, pre2 and flood of each patch as
    2-channel images (H, W, 2) f32, normalized; eval pads its last batch
    (sample_weight 0) with no mask to write. ``packed``: the split packed
    by the segmentation loader, read by the typed records' ids."""
    cfg = _cfg(base_config)
    if packed:
        seg = dict(cfg, task="segmentation")
        tshards.pack_split(TLoader(mode, seg, 3), tmp_path / mode, img_dtype="float32")
        cfg = dict(cfg, packed_shards=str(tmp_path))
    got_loader = TLoader(mode, cfg, seed=3)
    want_loader = JLoader(mode, cfg, seed=3, process_index=0, process_count=1)
    assert (got_loader.shard_reader is not None) == packed
    assert got_loader.num_samples() == 15 and [r.type for r in got_loader.records[:3]] == [
        "pre1", "pre2", "flood"]
    for _ in range(2):
        got, want = list(got_loader), list(want_loader)
        _assert_batches_equal(got, want)
    assert got[0]["image"].shape == (4, SIDE, SIDE, 2) and got[0]["image"].dtype == np.float32
    if mode == "val":
        np.testing.assert_array_equal(got[-1]["sample_weight"], [1, 1, 1, 0])
    got_loader.close()


def _train_cfg(base_config, path, **kw):
    # 8 patches -> 24 typed records, batch 8 (the JAX step shards the batch
    # over the tests' 8 CPU devices): 3 steps an epoch
    return _cfg(base_config, **{"batch_size": 8, "synthetic_size": 8, "epochs": 2,
                                "print_frequency": 1, "checkpoint_path": str(path / "diff"),
                                **kw})


def _losses(out: str) -> list[float]:
    return [float(x) for x in re.findall(r"^diffusion epoch \d+ iter \d+: loss=(\S+)$", out,
                                         re.M)]


def _names(path) -> set:
    ckpt = TCheckpoints(path)
    return {n for n in ("diffusion_0", "diffusion_1") if ckpt.has(n)}


@pytest.fixture
def jax_train(base_config, tmp_path_factory):
    """JAX's train() for 2 steps (max_steps; seed 1), its init and step
    compiled with FAST_COMPILE: its initial and final parameters, printed
    losses, checkpoint names, and the timesteps and noise of each step."""
    path = tmp_path_factory.mktemp("jax_diff")
    cfg = _train_cfg(base_config, path)
    mp = pytest.MonkeyPatch()
    init = {}
    real_state = j_diff.create_train_state

    def recording_state(model, *a, **kw):
        state, v = real_state(FastInit(model), *a, **kw)
        init["params"] = jax.tree.map(np.array, dict(state.params))
        return state, v

    mp.setattr(j_diff, "create_train_state", recording_state)
    mp.setattr(j_diff, "jax", FastJax())
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            state = j_diff.train(cfg, dict(MCFG), seed=1, max_steps=2)
    finally:
        mp.undo()
    rng, draws = jax.random.PRNGKey(1), []
    for _ in range(2):
        rng, k = jax.random.split(rng)
        kt, kn = jax.random.split(k)
        draws.append((np.asarray(jax.random.randint(kt, (8,), 0, MCFG["timesteps"])),
                      np.asarray(jax.random.normal(kn, (8, SIDE, SIDE, 2), jnp.float32))))
    return {"init": init["params"], "params": jax.tree.map(np.asarray, dict(state.params)),
            "losses": _losses(out.getvalue()), "names": _names(path / "diff"), "draws": draws,
            "step": int(state.step)}


def test_train_matches_jax(base_config, tmp_path, monkeypatch, capsys, jax_train):
    """Two steps from JAX's initial weights with JAX's draws: the printed
    losses, the parameters after Adam's two updates, ``diffusion_0``
    written (max_steps 2 ends epoch 0 and the epoch loop)."""
    real_init, real_step = t_diff.initialize_segmentation_model, t_diff.make_diffusion_train_step
    draws = iter(jax_train["draws"])

    def init(*a, **kw):
        model = real_init(*a, **kw)
        model.load_state_dict(flax_to_torch({"params": jax_train["init"]}))
        return model

    def make_step(*a, **kw):
        step = real_step(*a, **kw)

        def fed(state, batch, generator):
            t, noise = next(draws)
            return step(state, batch, generator, t=torch.from_numpy(t),
                        noise=torch.from_numpy(noise))

        return fed

    monkeypatch.setattr(t_diff, "initialize_segmentation_model", init)
    monkeypatch.setattr(t_diff, "make_diffusion_train_step", make_step)
    cfg = _train_cfg(base_config, tmp_path)
    recorded = []
    state = t_diff.train(cfg, dict(MCFG), seed=1, max_steps=2, device="cpu",
                         record_losses=recorded)
    losses = _losses(capsys.readouterr().out)
    assert state.step == jax_train["step"] == 2
    assert len(losses) == len(jax_train["losses"]) == 2
    np.testing.assert_allclose(losses, jax_train["losses"], atol=2e-5)
    np.testing.assert_allclose(recorded, losses, atol=5e-6)
    got = torch_to_flax(state.model.state_dict())["params"]
    want = jax_train["params"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    d = np.concatenate([np.abs(g - w).ravel()
                        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want))])
    total = 2 * MCFG["learning_rate"]
    assert d.max() <= 2 * total + 1e-7 and np.mean(d <= 0.3 * total) >= 0.99
    assert _names(tmp_path / "diff") == jax_train["names"] == {"diffusion_0"}
    payload, _ = TCheckpoints(tmp_path / "diff").load("diffusion_0")
    assert payload["step"] == 2 and "optimizer" in payload
    assert set(payload["model"]) == set(state.model.state_dict())


def test_train_runs_its_epochs_from_the_generator(base_config, tmp_path, capsys):
    """Without max_steps: every epoch (2 of 3 steps), ``diffusion_0`` and
    ``diffusion_1``, printed losses finite; the same seed gives the same
    losses (the timesteps and noise from the seeded generator)."""
    runs = []
    for k in range(2):
        cfg = _train_cfg(base_config, tmp_path / str(k), print_frequency=2)
        state = t_diff.train(cfg, dict(MCFG), seed=4, device="cpu")
        runs.append(_losses(capsys.readouterr().out))
        assert state.step == 6 and _names(tmp_path / str(k) / "diff") == {
            "diffusion_0", "diffusion_1"}
    assert len(runs[0]) == 4 and np.isfinite(runs[0]).all() and runs[0] == runs[1]


def test_train_refuses_without_a_card(base_config, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_diff.train(_train_cfg(base_config, tmp_path), dict(MCFG), seed=1)


def test_bench_leg_runs_on_the_cpu():
    from kurosiwo_torch import bench

    b = bench.setup_diffusion(2, device="cpu", model_config={"dim": 8, "dim_mults": [1, 2],
                                                             "timesteps": 10})
    assert b.batch["image"].shape == (2, 224, 224, 2) and b.lr == 1e-4
    b.batch["image"] = b.batch["image"][:, :SIDE, :SIDE]
    one = bench._diffusion_train_fn(b)
    losses = [float(one()) for _ in range(2)]
    assert np.isfinite(losses).all() and b.state.step == 2


def test_bench_leg_is_the_shipped_method_config():
    """The diffusion leg's model config is configs/method/diffusion/diffusion.json's."""
    import pathlib

    from kurosiwo_torch import bench
    from kurosiwo_torch.config import load_json5

    shipped = load_json5(pathlib.Path(__file__).resolve().parent.parent / "configs" / "method"
                         / "diffusion" / "diffusion.json")
    assert {k: shipped[k] for k in bench.DIFFUSION_MODEL_CONFIG} == bench.DIFFUSION_MODEL_CONFIG
    assert shipped["task"] == bench.DIFFUSION_CONFIG["task"]


@pytest.mark.parametrize("module", ["models/diffusion.py", "training/diffusion.py",
                                    "utils/visualize.py"])
def test_slice_modules_walk_and_import_no_jax(module):
    """The slice's modules are in the package walk, import without building
    a kernel, and import no JAX and nothing of the JAX package."""
    import ast
    import importlib
    import pathlib
    import pkgutil

    import kurosiwo_torch
    from kurosiwo_torch import kernels

    name = "kurosiwo_torch." + module[:-3].replace("/", ".")
    assert name in [m.name for m in pkgutil.walk_packages(kurosiwo_torch.__path__,
                                                          "kurosiwo_torch.")]
    importlib.import_module(name)
    path = pathlib.Path(kurosiwo_torch.__file__).parent / module
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "optax", "kurosiwo_tpu"}
    assert kernels._loaded == {}


def test_diffusion_entry_points_without_device_raise_on_a_cpu_box(monkeypatch):
    from kurosiwo_torch import bench
    from kurosiwo_torch.models.factory import initialize_segmentation_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_segmentation_model({"task": "diffusion-unsup", "method": "diffusion"}, MCFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.setup_diffusion(2)
