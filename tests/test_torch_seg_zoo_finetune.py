"""Port parity of the FloodViT finetuner (kurosiwo_torch/models/finetuner.py)
against kurosiwo_tpu's, with each of its three heads (mlp, decoder,
linear), the same weights carried through kurosiwo_torch.convert: a ViT of
dim 64, depth 2, 2 heads of 64, mlp 64, 16x16 patches of a 32x32 image,
batch 2, f32 on the CPU. For each head: the state_dict's names and shapes
against the flax tree and the bridge's round trip (the transposed-conv
kernels of the decoder head), eval and train-mode logits, one train step
and one eval step against JAX's make_train_step and make_eval_step
(tests/torch_seg_zoo_parity.py's bands), from one jitted JAX run a head.
The encoder's attention takes the short route in the port (B4's plain
version here) and JAX's einsum fallback on the CPU.
"""

import functools

import pytest
import torch

import torch_seg_zoo_parity as zp
from kurosiwo_torch.models import finetuner as tft
from kurosiwo_torch.models import vit as tvit
from kurosiwo_tpu.models import finetuner as jft
from kurosiwo_tpu.models import vit as jvit

torch.set_num_threads(2)

SIDE = 32
VIT = {"image_size": SIDE, "patch_size": 16, "dim": 64, "depth": 2, "heads": 2, "mlp_dim": 64,
       "channels": 6, "pool": "cls"}
HEADS = ("mlp", "decoder", "linear")


def _models(head: str):
    jm = lambda: jft.FinetunerSegmentation(jvit.ViT(**VIT), 3, head, 16, SIDE)
    tm = lambda: tft.FinetunerSegmentation(
        tvit.ViT(**VIT, generator=torch.Generator().manual_seed(0)), 3, head, 16, SIDE,
        generator=torch.Generator().manual_seed(1))
    return jm, tm


@functools.cache
def jax_run(head: str) -> dict:
    jm, tm = _models(head)
    res = zp.jax_run(jm(), tm(), zp.config("finetune", SIDE), SIDE)
    return {"jmodel": jm, "tmodel": tm, **res}


@pytest.fixture(params=HEADS)
def run(request):
    return jax_run(request.param)


def test_state_dict_names_and_round_trip_match_flax(run):
    zp.check_names_and_round_trip(run["jmodel"](), run["tmodel"](), run)


def test_eval_and_train_logits_match_jax(run):
    zp.check_outputs(run["tmodel"](), run)


def test_train_step_matches_jax(run):
    zp.check_train_step(run["tmodel"], run)


def test_eval_step_matches_jax(run):
    zp.check_eval_step(run["tmodel"](), run)


def test_input_of_another_side_raises_naming_image_size():
    model = _models("mlp")[1]()
    with pytest.raises(ValueError, match="image_size"):
        model(torch.zeros(1, 48, 48, 6))
