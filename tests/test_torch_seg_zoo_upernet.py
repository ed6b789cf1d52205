"""Port parity of UperNet (kurosiwo_torch/models/upernet.py, swin.py)
against kurosiwo_tpu's, the same weights carried through
kurosiwo_torch.convert, f32 on the CPU at batch 2, through the JAX tests'
``backbone_spec`` override and a 32-channel head: ConvNeXt at 64x64 (stages
16, 8, 4, 2: PSP's bins 3 and 6 exceed the 2x2 deepest map, the
antialiased resize) and Swin at 56x56 (stages 14, 7, 4, 2: the shifted
windows of 7 on 14x14, the shift on the one window of 7x7, an odd map
edge-padded for merging, windows of 4 and 2 unshifted). For each: the
state_dict's names and shapes against the flax tree and the bridge's round
trip (the grouped 7x7 kernel, the 4x4/s4 and 2x2/s2 convs, ``gamma``,
``relative_position_bias``, the bias-free ``merge{s}``), eval and
train-mode logits (atol 1e-3) and batch statistics, one train step and one
eval step against JAX's (tests/torch_seg_zoo_parity.py's bands), from one
jitted JAX run a backbone. Then the Swin helpers (window partition and
reverse, relative-position index, shift mask) against JAX's.
"""

import functools

import numpy as np
import pytest
import torch

import torch_seg_zoo_parity as zp
from kurosiwo_torch.models import swin as tswin
from kurosiwo_torch.models import upernet as tup
from kurosiwo_tpu.models import swin as jswin
from kurosiwo_tpu.models import upernet as jup

torch.set_num_threads(2)

# name: (backbone, spec, input side)
BACKBONES = {
    "convnext": ("convnext_tiny", ((1, 1, 2, 1), (16, 32, 48, 64)), 64),
    "swin": ("swin_tiny", ((2, 2, 2, 2), 32, (1, 2, 2, 4)), 56),
}
CHANNELS = 32


def _models(name: str):
    backbone, spec, side = BACKBONES[name]
    jm = lambda: jup.UperNet(3, backbone, channels=CHANNELS, backbone_spec=spec)
    tm = lambda: tup.UperNet(6, 3, backbone, channels=CHANNELS, backbone_spec=spec,
                             image_size=side, generator=torch.Generator().manual_seed(0))
    return jm, tm, side


@functools.cache
def jax_run(name: str) -> dict:
    jm, tm, side = _models(name)
    res = zp.jax_run(jm(), tm(), zp.config("upernet", side), side)
    return {"jmodel": jm, "tmodel": tm, **res}


@pytest.fixture(params=list(BACKBONES))
def run(request):
    return jax_run(request.param)


def test_state_dict_names_and_round_trip_match_flax(run):
    zp.check_names_and_round_trip(run["jmodel"](), run["tmodel"](), run)


def test_eval_and_train_logits_and_batch_stats_match_jax(run):
    zp.check_outputs(run["tmodel"](), run, atol=1e-3)


def test_train_step_matches_jax(run):
    zp.check_train_step(run["tmodel"], run)


def test_eval_step_matches_jax(run):
    zp.check_eval_step(run["tmodel"](), run)


@pytest.mark.parametrize("h,ws,shift", [(14, 7, 3), (7, 7, 3), (8, 4, 0)])
def test_swin_windows_index_and_mask_match_jax(h, ws, shift):
    x = np.random.RandomState(0).randn(2, h, h, 5).astype(np.float32)
    wins = tswin.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jswin.window_partition(x, ws)))
    back = tswin.window_reverse(wins, ws, h, h)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(tswin._relative_position_index(ws),
                                  jswin._relative_position_index(ws))
    if shift:
        np.testing.assert_array_equal(tswin._shift_mask(h, h, ws, shift),
                                      jswin._shift_mask(h, h, ws, shift))


def test_swin_refuses_a_map_its_windows_were_not_built_for():
    model = tup.UperNet(6, 3, "swin_tiny", channels=CHANNELS,
                        backbone_spec=BACKBONES["swin"][1], image_size=56)
    with pytest.raises(ValueError, match="image_size"):
        model(torch.zeros(1, 112, 112, 6))  # stage 3 at 7x7: windows of 7, built for 4
