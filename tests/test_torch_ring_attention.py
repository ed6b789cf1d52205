"""Context parallelism of the port on the CPU: ring attention
(kurosiwo_torch.ops.ring_attention) and the whole-scene CP encoder
(kurosiwo_torch.inference.vit_whole_scene_cp) at 2 and 4 Gloo ranks
(tests/torch_dist_worker.py), each rank holding its shard of the token
sequence, against the JAX package's ring_attention on a 4- and an 8-device
mesh (the port's tests/test_ring_attention.py) and its vit_whole_scene_cp on
a 2-device mesh.

Cases: the dense branch (shards of 32 and 16 tokens) and the flash branch
(4,096 tokens, shards of 2,048 and 1,024: B5's plain versions on the CPU,
with the global lse and delta in the backward), forward and the gradients
of sum((out - t)^2); the one-process ring_attention_shards equals the
distributed ring bitwise (the same steps, sums and order, one thread).

Bands (C5): f32, cross-framework against JAX atol 2e-5 on the outputs and
5e-5 on the gradients (the JAX ring tests' bands); the CP encoder atol 5e-4
(the single-process scene encode's band against JAX, tests/test_torch_inference.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kurosiwo_torch.convert import flax_to_torch
from kurosiwo_torch.models.vit import SelfAttention, ViT as TViT
from kurosiwo_torch.ops import ring_attention as tra
from kurosiwo_tpu import inference as jinf
from kurosiwo_tpu.models.vit import ViT as JViT
from kurosiwo_tpu.ops.ring_attention import ring_attention as j_ring_attention
from torch_dist_worker import run, spawn

CASES = {"dense": (2, 2, 64, 16), "flash": (1, 1, 4096, 32)}
DIMS = dict(patch_size=16, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
SCENE = 64  # 16 tokens


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*shape) * 0.5).astype(np.float32) for k in "qkvt"}


@pytest.fixture(scope="module")
def vit_params():
    jmodel = JViT(image_size=64, channels=2, pool="cls", dtype=jnp.float32, **DIMS)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 2)))["params"]
    return jax.tree.map(np.asarray, dict(params))


@pytest.fixture(scope="module")
def job(vit_params):
    tmodel = TViT(image_size=64, channels=2, pool="cls", **DIMS)
    tmodel.load_state_dict(flax_to_torch({"params": vit_params}))
    return {
        "ring": {"cases": {name: _inputs(shape, seed) for seed, (name, shape)
                           in enumerate(CASES.items())}},
        "cp": {"vit": dict(image_size=64, channels=2, pool="cls", **DIMS),
               "weights": {k: v.numpy() for k, v in tmodel.state_dict().items()},
               "scene": np.random.RandomState(9).randn(SCENE, SCENE, 2).astype(np.float32)},
    }


@pytest.fixture(scope="module")
def single(job):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run(job)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request, job):
    return request.param, spawn(request.param, job)


@pytest.fixture(scope="module")
def jax_ring(job):
    """JAX's ring attention on a 4- and an 8-device mesh (its dense branch on
    the CPU): the output and the gradients of sum((out - t)^2)."""
    out = {}
    for devices in (4, 8):
        mesh = Mesh(np.asarray(jax.devices()[:devices]), ("seq",))
        for name, case in job["ring"]["cases"].items():
            q, k, v, t = (jnp.asarray(case[x]) for x in "qkvt")

            def loss(q, k, v, mesh=mesh, t=t):
                o = j_ring_attention(q, k, v, mesh, "seq")
                return jnp.sum((o - t) ** 2), o

            (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
                q, k, v)
            out[devices, name] = {"out": np.asarray(o),
                                  **{f"d{x}": np.asarray(g) for x, g in zip("qkv", grads)}}
    return out


def _gathered(res: list, case: str) -> dict:
    return {k: np.concatenate([r["ring"][case][k] for r in res], axis=2)
            for k in ("out", "dq", "dk", "dv")}


@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_jax_and_one_process(ranks, single, jax_ring, case):
    world, res = ranks
    got = _gathered(res, case)
    want = jax_ring[2 * world, case]  # 2 ranks against the 4-device mesh, 4 against 8
    for k in got:
        atol = 2e-5 if k == "out" else 5e-5
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)
        np.testing.assert_allclose(single["ring"][case][k], want[k], atol=atol, rtol=0,
                                   err_msg=f"one process {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_ring_takes_the_flash_branch_on_long_shards(case):
    n = CASES[case][2]
    for p in (1, 2, 4):
        q = torch.zeros((1, 1, n // p, 32))
        assert (tra.ring_blocks(q, q) is tra.FLASH) == (case == "flash")
    assert tra.ring_blocks(q, q, plain=True) in (tra.FLASH_PLAIN, tra.DENSE)


@pytest.mark.parametrize("case", list(CASES))
def test_ring_shards_equal_the_distributed_ring_bitwise(ranks, job, case):
    world, res = ranks
    inputs = job["ring"]["cases"][case]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        shards = {x: [s.requires_grad_(True) for s in
                      torch.from_numpy(inputs[x]).chunk(world, dim=2)] for x in "qkv"}
        outs = tra.ring_attention_shards(shards["q"], shards["k"], shards["v"])
        ts = torch.from_numpy(inputs["t"]).chunk(world, dim=2)
        sum(((o - t) ** 2).sum() for o, t in zip(outs, ts)).backward()
    finally:
        torch.set_num_threads(threads)
    got = _gathered(res, case)
    np.testing.assert_array_equal(torch.cat(outs, dim=2).detach().numpy(), got["out"])
    for x in "qkv":
        np.testing.assert_array_equal(torch.cat([s.grad for s in shards[x]], dim=2).numpy(),
                                      got[f"d{x}"], err_msg=x)


def test_ring_bf16_gradients_are_finite():
    rs = np.random.RandomState(6)
    qs = [[torch.from_numpy(rs.randn(1, 2, 8, 16).astype(np.float32)).bfloat16()
           .requires_grad_(True) for _ in range(4)] for _ in range(3)]
    outs = tra.ring_attention_shards(*qs)
    sum(o.float().sum() for o in outs).backward()
    for shard in (s for group in qs for s in group):
        assert shard.grad.dtype == torch.bfloat16 and torch.isfinite(shard.grad.float()).all()


@pytest.fixture(scope="module")
def jax_cp(job, vit_params):
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    return np.asarray(jinf.vit_whole_scene_cp(vit_params, job["cp"]["scene"], mesh, "seq",
                                              dtype=jnp.float32, **DIMS))


def test_cp_encoder_matches_jax(ranks, single, jax_cp):
    """Every rank returns the gathered tokens, the one-process (a ring of
    one) encode's, and JAX's on a 2-device mesh."""
    _, res = ranks
    want = jax_cp
    assert want.shape == (1, (SCENE // 16) ** 2, DIMS["dim"])
    for r in res:
        np.testing.assert_array_equal(r["cp"]["tokens"], res[0]["cp"]["tokens"])
    np.testing.assert_allclose(res[0]["cp"]["tokens"], single["cp"]["tokens"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(res[0]["cp"]["tokens"], want, atol=5e-4, rtol=0)


def test_cp_encoder_refuses_a_grid_the_ring_does_not_divide(vit_params):
    from kurosiwo_torch.inference import vit_whole_scene_cp
    from kurosiwo_torch.parallel.mesh import MeshPlan

    tmodel = TViT(image_size=64, channels=2, pool="cls", **DIMS)
    with pytest.raises(ValueError, match="does not divide by the ring size 3"):
        vit_whole_scene_cp(tmodel, np.zeros((16, 64, 2), np.float32), MeshPlan(num_model=3),
                           device="cpu")


def test_ring_attention_of_one_process_is_attention():
    """A ring of this process alone (SOLO) inside the ViT's attention gives
    the attention over the tokens given, with the parameter names
    unchanged."""
    torch.manual_seed(0)
    plain = SelfAttention(64, 2, 32)
    ring = SelfAttention(64, 2, 32, ring_axis=tra.SOLO)
    ring.load_state_dict(plain.state_dict())
    assert list(ring.state_dict()) == list(plain.state_dict())
    x = torch.randn(2, 24, 64)
    torch.testing.assert_close(ring(x, torch.float32), plain(x, torch.float32),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(plain(x, torch.float32, ring_axis=tra.SOLO),
                               plain(x, torch.float32), atol=1e-5, rtol=0)

