"""Port parity of UNet++ and DeepLabV3+ (kurosiwo_torch/models/unet.py)
against kurosiwo_tpu's, the same weights carried through
kurosiwo_torch.convert, at 64x64 and batch 2, f32 on the CPU: UNet++ on
resnet18 (JAX's ``fold_up`` on, its default, for the run; its eval logits
with ``fold_up`` off too, the same function from the same parameters),
DeepLabV3+ on resnet18 and on a Bottleneck trunk (resnet50's blocks at one
block a stage, registered under the same name in both packages' specs, so
the trunk keeps resnet50's widths: 256 to 2048 channels, the projection on
layer1_0, the dilated layer4). For each: the state_dict's names and shapes
against the flax tree and the bridge's round trip, eval and train-mode
logits and the batch statistics, one train step and one eval step against
JAX's make_train_step and make_eval_step (tests/torch_seg_zoo_parity.py's
bands), from one jitted JAX run a model.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_seg_zoo_parity as zp
from kurosiwo_torch.models import resnet as tres
from kurosiwo_torch.models import unet as tunet
from kurosiwo_tpu.models import resnet as jres
from kurosiwo_tpu.models import unet as junet

torch.set_num_threads(2)

SIDE = 64
# resnet50's Bottleneck at one block a stage: the width plan of resnet50 at a
# fraction of its depth
BOTTLENECK = "bottleneck_1111"

def _seeded(cls, *args):
    return lambda: cls(*args, generator=torch.Generator().manual_seed(0))


# name: (method, backbone, JAX model, port model, batch). DeepLabV3+ runs at
# batch 4: its global-pool branch's BatchNorm normalizes B values a channel,
# and at B = 2 its output is +-scale whatever its input, its gradient
# rounding noise scaled by 1 / |x1 - x2|
MODELS = {
    "unet++": ("unet++", "resnet18", lambda: junet.UNetPlusPlus(3, "resnet18"),
               _seeded(tunet.UNetPlusPlus, 6, 3, "resnet18"), 2),
    "deeplabv3": ("deeplabv3", "resnet18", lambda: junet.DeepLabV3Plus(3, "resnet18"),
                  _seeded(tunet.DeepLabV3Plus, 6, 3, "resnet18"), 4),
    "deeplabv3 bottleneck": ("deeplabv3", BOTTLENECK, lambda: junet.DeepLabV3Plus(3, BOTTLENECK),
                             _seeded(tunet.DeepLabV3Plus, 6, 3, BOTTLENECK), 4),
}


@pytest.fixture(scope="module", autouse=True)
def bottleneck_spec():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jres.RESNET_SPECS, BOTTLENECK, (jres.Bottleneck, (1, 1, 1, 1)))
        mp.setitem(tres.RESNET_SPECS, BOTTLENECK, (tres.Bottleneck, (1, 1, 1, 1)))
        yield


@functools.cache
def jax_run(name: str) -> dict:
    method, backbone, jmodel, tmodel, n = MODELS[name]
    res = zp.jax_run(jmodel(), tmodel(), zp.config(method, SIDE, n), SIDE,
                     {"backbone": backbone})
    return {"name": name, "jmodel": jmodel, "tmodel": tmodel, **res}


@pytest.fixture(params=list(MODELS))
def run(request):
    return jax_run(request.param)


def test_state_dict_names_and_round_trip_match_flax(run):
    zp.check_names_and_round_trip(run["jmodel"](), run["tmodel"](), run)


def test_eval_and_train_logits_and_batch_stats_match_jax(run):
    zp.check_outputs(run["tmodel"](), run)


def test_train_step_matches_jax(run):
    zp.check_train_step(run["tmodel"], run)


def test_eval_step_matches_jax(run):
    zp.check_eval_step(run["tmodel"](), run)


def test_unetplusplus_without_fold_up_is_the_same_function():
    """JAX's UNet++ with ``fold_up`` off (the up-leg upsampled and
    concatenated, not folded) gives the port's logits too."""
    run = jax_run("unet++")
    jm = junet.UNetPlusPlus(3, "resnet18", fold_up=False)
    want = np.asarray(zp.cdp.jit_fast(lambda v, x: jm.apply(v, x, train=False),
                                      jax.tree.map(jnp.asarray, run["v"]), run["x"]))
    zp.check_outputs(run["tmodel"](), run, eval_logits=want)


def test_bottleneck_trunk_pyramid_and_statistics_match_jax():
    """ResNetEncoder at resnet50 and resnet101 (width 8) at (4, 64, 64): the
    pyramid in eval mode (atol 5e-4), in train mode and the updated batch
    statistics, and the state_dict's names (layer1_0's projection
    ConvBNAct_3, 4x channels). Train mode is held in relative L2 norm, the
    pyramid within 5e-3 and the statistics within 1e-3: 16 and 33
    Bottlenecks of train-mode BatchNorms amplify f32 rounding (in one
    framework, a 1e-6 change of the input moves resnet101's /16 and /32
    maps by up to 9e-3, its eval maps by 3e-6)."""
    from kurosiwo_torch.convert import torch_to_flax

    x = np.random.RandomState(3).randn(4, 64, 64, 6).astype(np.float32)
    for backbone, blocks in (("resnet50", 16), ("resnet101", 33)):
        tm = tres.ResNetEncoder(6, backbone, width=8, generator=torch.Generator().manual_seed(0))
        jm = jres.ResNetEncoder(backbone, width=8)
        v = zp.variables(tm)
        ev, (feats, upd) = zp.cdp.jit_fast(
            lambda v, x: (jm.apply(v, x, train=False),
                          jm.apply(v, x, train=True, mutable=["batch_stats"])),
            jax.tree.map(jnp.asarray, v), jnp.asarray(x))
        zp.load(tm, v).eval()
        with torch.no_grad():
            got_ev = tm(torch.from_numpy(x), torch.float32)
            tm.train()
            got = tm(torch.from_numpy(x), torch.float32)
        assert tm.channels == [6, 8, 32, 64, 128, 256]
        assert [tuple(f.shape) for f in got] == [f.shape for f in feats]
        for g, w in zip(got_ev, ev):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4)
        for g, w in zip(got, feats):
            assert zp.rel_l2(g.numpy(), np.asarray(w)) <= 5e-3
        stats = torch_to_flax(tm.state_dict())["batch_stats"]
        want = zp.cdp.tree(upd["batch_stats"])
        assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree.leaves(stats), jax.tree.leaves(want)):
            assert zp.rel_l2(g, w) <= 1e-3
        names = tm.state_dict()
        assert sum(k.endswith("ConvBNAct_3.Conv_0.weight") for k in names) == 4
        assert names["layer1_0.ConvBNAct_3.Conv_0.weight"].shape == (32, 8, 1, 1)
        assert sum(k.startswith("layer") and k.endswith("ConvBNAct_0.BatchNorm_0.mean")
                   for k in names) == blocks
