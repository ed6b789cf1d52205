"""Tensor parallelism of the port (kurosiwo_torch/parallel/sharding.py and the
layers it cuts) on the CPU: 4 Gloo ranks as DP(2) x TP(2), spawned once for
the module (tests/torch_dist_worker.py), against the port's one process
and the JAX package's unsharded model.

  (i) the rule: the leaves JAX's ``_spec_for`` shards are the ones
      ``param_shardings`` picks, on JAX's own test leaves and on a small
      ViT, a UNet and a transposed conv through convert.py's names, each on
      its flax last axis (torch dim 0 of a weight: the transposed conv's is
      Cin, its flax HWOI kernel's last axis);
 (ii) the TP(2) ViT forward (dim 256, depth 2, 4 heads, 32^2, as
      tests/test_parallel.py:36-59) against JAX's unsharded ``model.apply``
      at atol 2e-4 (JAX's bound) and the port's one process within 1e-5 of
      the largest |output| (the row-parallel sums in another order);
(iii) a DP(2) x TP(2) UNet SGD step against one process: loss rtol 1e-5,
      parameters and statistics atol 1e-5, confusion counts equal (JAX's
      bounds, tests/test_parallel.py:118-121); the replicated parameters'
      gradients bitwise equal on both model ranks; B3 on half the channels
      of every cut conv;
 (iv) ``gather_state`` equal to one process's state; a checkpoint written
      under TP loads into one process's model; the moments of one Adam step
      from the same weights, made on the cut parameters, gathered whole,
      each within 1e-3 in L2 norm of one process's (the gradients of (iii):
      the stem's sums its ranks' partial input gradients in another order
      through every block, 1.8e-4 seen);
      ``apply_shardings`` cuts an optimizer's existing moments with their
      parameter;
  (v) the qkv-by-head cut (ROADMAP C26);
 (vi) ``vit_whole_scene_cp`` refusing a TP-sharded model; the MAE (its
      positions read across modules) and BiT-CD (a cut parameter in a module
      with no sliced forward) at one process's numbers;
(vii) ``python -m kurosiwo_torch.parallel.dryrun --ranks 4`` exiting 0.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.models.factory import initialize_segmentation_model as t_init_model
from kurosiwo_torch.models.vit import ViT as TViT
from kurosiwo_torch.ops.nn import TorchConvTranspose as TConvT
from kurosiwo_torch.parallel.mesh import MeshPlan, ModelShard
from kurosiwo_torch.parallel.sharding import param_shardings, spec_for
from kurosiwo_tpu.models.vit import ViT as JViT
from kurosiwo_tpu.ops.nn import TorchConvTranspose as JConvT
from kurosiwo_tpu.parallel.sharding import _spec_for
from torch_cd_parity import jit_fast
from torch_dist_worker import run, spawn

REPO = Path(__file__).resolve().parent.parent
VIT = {"image_size": 32, "patch_size": 16, "dim": 256, "depth": 2, "heads": 4, "mlp_dim": 512,
       "channels": 2, "dim_head": 64}
CFG = {"task": "segmentation", "method": "unet", "num_classes": 3, "mixed_precision": False,
       "num_channels": 2, "inputs": ["post_event"], "channels": ["vv", "vh"], "dem": False,
       "weighted": True, "class_weights": [0.3716, 14.0098, 8.2041],
       "loss_function": "cross_entropy", "batch_size": 8, "fused_tail": False}
MCFG = {"backbone": "resnet18", "learning_rate": 1e-2}
B, SIDE = 8, 32
VIT_MIN, UNET_MIN = 1024, 1 << 12  # the JAX test's and the dry run's min_size
TP2 = MeshPlan(num_model=2)
MAE_CONFIG = {"image_size": 32, "patch_size": 8, "dim": 32, "depth": 1, "heads": 2,
              "mlp_dim": 64, "decoder_dim": 32, "decoder_depth": 1, "decoder_heads": 2,
              "masked_ratio": 0.75}


def _jax_picks(tree: dict, min_size: int) -> dict:
    """{torch name: whether JAX's _spec_for shards the flax leaf}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in leaves:
        keys = [str(k.key) for k in path]
        name = "weight" if keys[-1] == "kernel" else keys[-1]
        out[".".join(keys[:-1] + [name])] = _spec_for(path, leaf, 2, min_size) != \
            jax.sharding.PartitionSpec()
    return out


def _compare_rule(module: torch.nn.Module, flax_params: dict, min_size: int) -> int:
    want = _jax_picks(flax_params, min_size)
    got = param_shardings(TP2, module, min_size)
    assert sorted(got) == sorted(want)
    for name, dim in got.items():
        assert (dim is not None) == want[name], name
        if dim is not None:
            p = module.get_parameter(name)
            assert dim == (0 if name.endswith("weight") else p.dim() - 1), name
    return sum(want.values())


def test_rule_on_jax_test_leaves():
    """tests/test_parallel.py:20-33's leaves at min_size 1024."""
    leaves = {"big": (512, 512), "small": (4, 4), "odd": (512, 129), "bias": (512,)}
    for name, shape in leaves.items():
        want = _spec_for((), np.zeros(shape), 2, 1024) != jax.sharding.PartitionSpec()
        assert spec_for(shape, 2, 1024) == want, name
    assert spec_for((512, 512), 1, 1024) is False
    assert spec_for((4, 1024 * 15), 2, 1 << 16) is False  # under min_size
    assert spec_for((16, 4096 * 2), 2, 1 << 16) is True
    assert spec_for((64, 4096), 1024, 1 << 12) is False  # 4 features a rank, under 8


def test_rule_on_vit_unet_and_transposed_conv():
    vit = TViT(**VIT, generator=torch.Generator().manual_seed(0))
    jvit = JViT(**VIT, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jvit.init(k, jnp.zeros((1, 32, 32, 2))),
                            jax.random.PRNGKey(0))["params"]
    assert _compare_rule(vit, shapes, VIT_MIN) == 10  # pos, patch_proj, 4 a block

    from kurosiwo_tpu.models.factory import initialize_segmentation_model as j_init_model

    unet = t_init_model(CFG, MCFG, device="cpu")
    junet = j_init_model(CFG, MCFG)
    shapes = jax.eval_shape(lambda k: junet.init(k, jnp.zeros((1, 64, 64, 2))),
                            jax.random.PRNGKey(0))["params"]
    assert _compare_rule(unet, shapes, UNET_MIN) > 20

    conv_t = TConvT(32, 64, 2, stride=2)
    shapes = jax.eval_shape(lambda k: JConvT(64, 2, 2).init(k, jnp.zeros((1, 8, 8, 32))),
                            jax.random.PRNGKey(0))["params"]
    assert shapes["kernel"].shape == (2, 2, 64, 32)  # HWOI: the last axis is Cin
    assert _compare_rule(conv_t, shapes, 1024) == 1
    assert param_shardings(TP2, conv_t, 1024)["weight"] == 0  # (Cin, Cout, k, k)


def test_model_shard_cut_and_join_round_trip():
    full = torch.arange(3 * 8 * 5, dtype=torch.float32).reshape(24, 5)
    for layout in ("block", "thirds"):
        shards = [ModelShard(None, m, 2, 0, (24, 5), layout) for m in range(2)]
        parts = [s.cut(full) for s in shards]
        assert all(p.shape == (12, 5) for p in parts)
        assert torch.equal(shards[0].join(parts), full)
    thirds = [ModelShard(None, m, 2, 0, (24, 5), "thirds").cut(full) for m in range(2)]
    assert torch.equal(thirds[1], torch.cat([full[4:8], full[12:16], full[20:24]]))


def test_apply_shardings_cuts_existing_moments():
    """Rank 1 of a TP(2) grid (no collective runs here): each picked
    parameter and its Adam moments become their slices, in place."""
    from kurosiwo_torch.parallel.sharding import apply_shardings

    vit = TViT(**VIT, generator=torch.Generator().manual_seed(0))
    adam = torch.optim.Adam(vit.parameters(), lr=1e-3)
    for p in vit.parameters():
        p.grad = torch.ones_like(p)
    adam.step()
    before = {n: (p.detach().clone(), adam.state[p]["exp_avg_sq"].clone())
              for n, p in vit.named_parameters()}
    plan = MeshPlan(num_data=1, num_model=2, model_index=1, data_group=object())
    cuts = apply_shardings(plan, vit, adam, min_size=VIT_MIN)
    assert len(cuts) == 10
    for n, p in vit.named_parameters():
        whole, moment = before[n]
        if n in cuts:
            assert torch.equal(p.detach(), cuts[n].cut(whole))
            assert torch.equal(adam.state[p]["exp_avg_sq"], cuts[n].cut(moment))
        else:
            assert torch.equal(p.detach(), whole)


def _batch(seed: int) -> dict:
    rs = np.random.RandomState(seed)
    b = {k: rs.randn(B, SIDE, SIDE, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["mask"] = rs.randint(0, 4, (B, SIDE, SIDE)).astype(np.int32)
    b["valid"] = np.ones((B, SIDE, SIDE), np.int32)
    for k in ("clz", "activation"):
        b[k] = np.ones((B,), np.int32)
    b["sample_weight"] = np.ones((B,), np.float32)
    return b


@pytest.fixture(scope="module")
def job():
    vit = TViT(**VIT, generator=torch.Generator().manual_seed(0))
    unet = t_init_model(CFG, MCFG, device="cpu")
    rs = np.random.RandomState(0)
    return {
        "tp_vit": {"vit": VIT, "weights": {k: v.numpy() for k, v in vit.state_dict().items()},
                   "min_size": VIT_MIN, "x": rs.randn(B, 32, 32, 2).astype(np.float32),
                   "scene": rs.randn(64, 64, 2).astype(np.float32)},
        "tp_unet": {"config": CFG, "model_config": MCFG, "min_size": UNET_MIN, "lr": 1e-2,
                    "init": {k: v.numpy() for k, v in unet.state_dict().items()},
                    "batch": _batch(1)},
        "tp_models": {"mae_config": MAE_CONFIG, "min_size": 256,
                      "image": rs.randn(2, 32, 32, 6).astype(np.float32),
                      "noise": rs.rand(2, 16).astype(np.float32),
                      "frames": [rs.randn(2, 64, 64, 2).astype(np.float32) for _ in range(2)]},
    }


@pytest.fixture(scope="module")
def single(job, tmp_path_factory):
    threads, cwd = torch.get_num_threads(), os.getcwd()
    torch.set_num_threads(1)
    os.chdir(tmp_path_factory.mktemp("one_process"))
    try:
        return run(job)
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(job):
    return spawn(4, job)


def _rows(rank: int) -> slice:
    d = rank // 2
    return slice(d * B // 2, (d + 1) * B // 2)


def test_tp_vit_matches_jax_and_one_process(ranks, single, job):
    spec = job["tp_vit"]
    model = JViT(**VIT, dtype=jnp.float32)
    params = torch_to_flax({k: torch.from_numpy(v) for k, v in spec["weights"].items()})["params"]
    ref = np.asarray(jit_fast(lambda p, x: model.apply({"params": p}, x), params,
                              jnp.asarray(spec["x"])))
    one = single["tp_vit"]["out"]
    np.testing.assert_allclose(one, ref, atol=2e-4)
    band = 1e-5 * np.abs(one).max()
    for r, res in enumerate(ranks):
        out = res["tp_vit"]["out"]
        np.testing.assert_allclose(out, ref[_rows(r)], atol=2e-4)
        np.testing.assert_allclose(out, one[_rows(r)], rtol=0, atol=band)
        assert len(res["tp_vit"]["cuts"]) == 10


def test_dp_tp_unet_step_matches_one_process(ranks, single):
    one = single["tp_unet"]
    for r, res in enumerate(ranks):
        got = res["tp_unet"]
        assert got["loss"] == pytest.approx(one["loss"], rel=1e-5)
        assert np.array_equal(got["cm"], one["cm"])
        assert sorted(got["state"]) == sorted(one["state"])
        for k, v in one["state"].items():
            np.testing.assert_allclose(got["state"][k], v, atol=1e-5, err_msg=k)
        assert len(got["cut"]) > 20


def test_replicated_gradients_equal_on_both_model_ranks(ranks):
    for a, b in ((0, 1), (2, 3)):
        ga, gb = ranks[a]["tp_unet"]["grads"], ranks[b]["tp_unet"]["grads"]
        assert sorted(ga) == sorted(gb) and ga
        for k in ga:
            assert np.array_equal(ga[k], gb[k]), k


def test_batchnorm_runs_on_the_cut_channels(ranks, single):
    """B3's calls (forward and backward) on every rank: the one process's
    widths, halved for the BatchNorm of each cut conv."""
    one = single["tp_unet"]["bn_widths"]
    for res in ranks:
        got = res["tp_unet"]["bn_widths"]
        assert len(got) == len(one) == 60
        assert all(g in (w, w // 2) for g, w in zip(got, one))
        assert sum(g == w // 2 for g, w in zip(got, one)) > 30


def test_gathered_state_checkpoint_and_moments(ranks, single):
    one = single["tp_unet"]
    for res in ranks:
        got = res["tp_unet"]
        assert sorted(got["checkpoint"]) == sorted(one["checkpoint"])
        for k, v in one["checkpoint"].items():
            assert got["checkpoint"][k].shape == v.shape
            np.testing.assert_allclose(got["checkpoint"][k], v, atol=1e-5, err_msg=k)
        assert sorted(got["adam"]) == sorted(one["adam"])
        for name, moments in one["adam"].items():
            for k, v in moments.items():
                g = got["adam"][name][k]
                assert g.shape == v.shape, (name, k)
                assert np.linalg.norm(g - v) <= 1e-3 * np.linalg.norm(v), (name, k)


def test_qkv_is_cut_by_head(ranks, job):
    """C26: rank m holds q, k and v of heads [m H/P, (m+1) H/P) of the packed
    to_qkv (JAX's cut is one block of columns: all of q and half of k on
    rank 0), to_out and fc2 their input features (JAX: their outputs)."""
    w = job["tp_vit"]["weights"]
    qkv = w["transformer.attn_0.to_qkv.weight"]  # (3 * inner, dim), rows q | k | v
    inner = qkv.shape[0] // 3
    for r, res in enumerate(ranks):
        m, half = r % 2, inner // 2
        cuts, slices = res["tp_vit"]["cuts"], res["tp_vit"]["slices"]
        assert cuts["transformer.attn_0.to_qkv.weight"][:2] == (0, "thirds")
        want = np.concatenate([qkv[t * inner + m * half: t * inner + (m + 1) * half]
                               for t in range(3)])
        got = slices["transformer.attn_0.to_qkv.weight"]
        assert np.array_equal(got, want)
        assert not np.array_equal(got, qkv[m * 3 * half: (m + 1) * 3 * half])  # JAX's block
        for name in ("transformer.attn_0.to_out.weight", "transformer.ff_0.fc2.weight"):
            full = w[name]
            cols = full.shape[1] // 2
            assert cuts[name][:2] == (1, "block")
            assert np.array_equal(slices[name], full[:, m * cols: (m + 1) * cols])
        rows = w["transformer.ff_0.fc1.weight"].shape[0] // 2
        assert np.array_equal(slices["transformer.ff_0.fc1.weight"],
                              w["transformer.ff_0.fc1.weight"][m * rows: (m + 1) * rows])


def test_mae_under_tp_matches_one_process(ranks, single):
    """The MAE at min_size 256 (its blocks, positions and decoder table
    cut): the loss and every gradient (cut ones gathered) of one process."""
    one = single["tp_models"]
    for res in ranks:
        got = res["tp_models"]
        assert {"encoder.pos_embedding", "decoder_pos_emb.embedding"} <= set(got["cuts"]["mae"])
        assert got["mae_loss"] == pytest.approx(one["mae_loss"], rel=1e-5)
        assert sorted(got["mae_grads"]) == sorted(one["mae_grads"])
        for k, v in one["mae_grads"].items():
            np.testing.assert_allclose(got["mae_grads"][k], v, rtol=0,
                                       atol=1e-5 * max(np.abs(v).max(), 1e-3), err_msg=k)


def test_bit_cd_with_a_whole_parameter_owner_matches_one_process(ranks, single):
    """BiT-CD's pos_embedding is cut, and its owner (no sliced forward)
    takes it whole for its forward: the eval logits of one process."""
    one = single["tp_models"]["bit"]
    for res in ranks:
        got = res["tp_models"]
        assert "pos_embedding" in got["cuts"]["bit"]
        np.testing.assert_allclose(got["bit"], one, rtol=0, atol=1e-5 * np.abs(one).max())


def test_cp_encoder_refuses_a_tp_sharded_model(ranks):
    for res in ranks:
        assert "takes a whole encoder" in res["tp_vit"]["cp_refusal"]


def test_dryrun_exits_zero():
    proc = subprocess.run([sys.executable, "-m", "kurosiwo_torch.parallel.dryrun", "--ranks",
                           "4", "--timeout", "240"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("dryrun OK")]
    assert len(line) == 1 and "grid (2, 2)" in line[0] and "over 4 ranks" in line[0]
