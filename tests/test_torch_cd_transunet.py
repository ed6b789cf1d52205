"""Port parity of TransUNet-CD (kurosiwo_torch/models/transunet_cd.py)
against kurosiwo_tpu's, with ``siamese`` off (one encoder a frame, the
shipped config) and on (one shared encoder), the same weights carried
through kurosiwo_torch.convert, at 32x32 (the ViT grid 2x2, 4 tokens and
the cls token) and batch 2, f32 on the CPU, at out_channels 16 (ViT width
128, 2 heads of 64: the B4 route in the port, einsum in JAX on the CPU),
mlp 32 and 2 blocks: the state_dict's names and shapes against the flax
tree (the cls token, the position table sized for 32x32) and the bridge's
round trip (bit-exact); eval and train outputs and the batch statistics
(atol 5e-4); one train step with the shipped AdamW (betas 0.9 and 0.009,
decay 0.01) at lr 1e-3 and one eval step against JAX's (the bands of
tests/test_torch_cd_steps.py). One jitted JAX run per form
(torch_cd_parity.attention_run). Then the (d, k, h) qkv layout and the
score multiplied by sqrt(head_dim) at the shipped head dimension 256.

The ViT's qkv kernels are scaled by 0.1 in these weights. The reference
multiplies the scores by sqrt(head_dim) = 8, so at the init's scale they
reach +-80 and the softmax weighs near-tied large logits against each
other: there the two frameworks' f32 sums, taken in another order, show at
up to 8.4e-4 in a few of the train outputs (the eval outputs agree to
3e-7). Scaled, the scores stay where the softmax is smooth, and the same
outputs agree to 1.7e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cd_parity as cdp
from kurosiwo_torch.convert import flax_to_torch
from kurosiwo_torch.models import transunet_cd as ttu
from kurosiwo_tpu.models import transunet_cd as jtu

torch.set_num_threads(2)

WIDTH = {"out_channels": 16, "head_num": 2, "mlp_dim": 32, "block_num": 2}


def _variables(mcfg: dict) -> dict:
    v = cdp.variables("transunet-cd", mcfg=mcfg)
    for name, enc in v["params"].items():
        if name.startswith("encoder"):
            for block in (b for k, b in enc["vit"].items() if k.startswith("block_")):
                block["qkv"]["kernel"] = block["qkv"]["kernel"] * np.float32(0.1)
    return v


@pytest.fixture(scope="module", params=[False, True], ids=["per-frame", "siamese"])
def run(request):
    mcfg = cdp.method_config("transunet-cd", siamese=request.param, **WIDTH)
    assert mcfg["optimizer"] == "adamw" and mcfg["betas"] == [0.9, 0.009]
    return cdp.attention_run("transunet-cd", mcfg, v=_variables(mcfg))


def test_state_dict_names_and_round_trip_match_flax(run):
    cdp.check_names_and_round_trip(run)
    sd = cdp.port_model(run).state_dict()
    enc = "encoder" if run["mcfg"]["siamese"] else "encoder1"
    assert sd[f"{enc}.vit.embedding"].shape == (5, 128)
    assert sd[f"{enc}.vit.cls_token"].shape == (1, 1, 128)


def test_eval_and_train_outputs_and_batch_stats_match_jax(run):
    cdp.check_outputs(run)


def test_train_step_matches_jax(run):
    cdp.check_train_step(run)


def test_eval_step_matches_jax(run):
    cdp.check_eval_step(run)


def test_post_norm_block_at_the_shipped_head_dim_matches_jax():
    """One post-norm block at the shipped ViT width (1024, 4 heads of 256:
    the einsum route in both packages): the (d, k, h) split of the fused
    qkv and the scores multiplied by sqrt(256)."""
    rs = np.random.RandomState(0)
    x = rs.randn(1, 5, 1024).astype(np.float32)
    block = jtu.PostNormBlock(1024, 4, 64)
    v = block.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # small qkv weights keep the multiplied scores where softmax is smooth
    v = {"params": dict(v["params"], qkv={"kernel": v["params"]["qkv"]["kernel"] * 0.05})}
    want = np.asarray(block.apply(v, jnp.asarray(x)))
    port = ttu.PostNormBlock(1024, 4, 64)
    port.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, v)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)
    qkv = torch.arange(2 * 3 * 6, dtype=torch.float32).reshape(1, 1, 36)
    want = jtu._split_ref_layout(jnp.asarray(qkv.numpy()), 2)
    for t, j in zip(ttu._split_ref_layout(qkv, 2), want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
