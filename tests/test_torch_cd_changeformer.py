"""Port parity of ChangeFormerV6 (kurosiwo_torch/models/changeformer.py)
against kurosiwo_tpu's, the same weights carried through
kurosiwo_torch.convert, at 32x32 (stages 8, 4, 2, 1) and batch 2 with
embed_dim 32 (the encoder at its published widths), f32 on the CPU. One
jitted JAX run (torch_cd_parity.attention_run) with the shipped method
config (SGD, momentum 0.99, decay 1e-5) at lr 1e-3 and multi_scale_train
on, its DropPath masks drawn from a seeded numpy stream on the JAX side and
fed to the port (ROADMAP C19):

* the state_dict's names and shapes against the flax tree (the depthwise
  kernel, the ``sr`` convs, the transposed convs of the tail) and the
  bridge's round trip (bit-exact);
* the five eval and train heads and the batch statistics (atol 5e-4);
* one train step with the multi-scale loss (the heads resized with
  jax.image.resize's "bilinear") and one eval step, plain and with
  multi_scale_infer, against JAX's (tests/test_torch_cd_steps.py's bands).

Then, within torch: ``remat_ffn`` on against off, and both memory keys
under the whole-forward remat, leave the outputs and every gradient bitwise
the same; ``tail_chunks`` 8 against 1 the outputs bitwise and the gradients
within an f32 band (not bitwise: another order of the same sums); their "auto" rules; the linear
schedule; ``resize_linear`` against jax.image.resize.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cd_parity as cdp
from kurosiwo_torch.models import changeformer as tcf
from kurosiwo_torch.models.factory import initialize_cd_model as t_init
from kurosiwo_torch.ops import nn as tnn
from kurosiwo_torch.ops.schedules import create_lr_schedule as t_schedule
from kurosiwo_tpu.models import changeformer as jcf
from kurosiwo_tpu.ops.schedules import create_lr_schedule as j_schedule

torch.set_num_threads(2)

WIDTH = {"embed_dim": 32}


@pytest.fixture(scope="module")
def run():
    mcfg = cdp.method_config("changeformer", multi_scale_train=True, **WIDTH)
    assert mcfg["multi_pred_weights"] == [0.5, 0.5, 0.5, 0.8, 1.0]
    return cdp.attention_run("changeformer", mcfg, infer=True)


def test_state_dict_names_and_round_trip_match_flax(run):
    cdp.check_names_and_round_trip(run)
    sd = cdp.port_model(run).state_dict()
    assert sd["Tenc_x2.block1_0.mlp.dwconv.weight"].shape == (256, 1, 3, 3)
    assert sd["TDec_x2.convd2x.weight"].shape == (32, 32, 4, 4)


def test_eval_and_train_heads_and_batch_stats_match_jax(run):
    assert len(run["train"]) == len(run["eval"]) == 5
    assert [h.shape[1] for h in run["eval"]] == [1, 2, 4, 8, 32]
    # 2 frames x 12 blocks with a rate above 0, two DropPaths a block
    assert len(run["train_masks"]) == len(run["step_masks"]) == 48
    cdp.check_outputs(run)


def test_multiscale_train_step_matches_jax(run):
    cdp.check_train_step(run)


@pytest.mark.parametrize("infer", [False, True], ids=["last-head", "multi_scale_infer"])
def test_eval_step_matches_jax(run, infer):
    if infer:
        cdp.check_eval_step(run, "infer", multi_scale_infer=True)
    else:
        cdp.check_eval_step(run)


def _grads(cfg: dict, mcfg: dict, weights: dict, x, masks, remat: bool = False):
    """Outputs and every parameter's gradient of one train-mode forward
    and backward (the whole-forward remat with ``remat``)."""
    from kurosiwo_torch.ops.remat import remat as whole

    model = t_init(cfg, mcfg, device="cpu").train()
    model.load_state_dict(weights)
    with cdp.fed_masks(masks, tnn.DropPath):
        out = whole(model, *x) if remat else model(*x)
    sum(((i + 1) * o).sum() for i, o in enumerate(out)).backward()
    return ([o.detach() for o in out],
            {n: p.grad for n, p in model.named_parameters()},
            {k: v for k, v in model.state_dict().items() if k.endswith(("mean", "var"))})


def _assert_same(ref, got, tag, grads_bitwise: bool = True):
    for a, b in zip(ref[0], got[0]):
        assert torch.equal(a, b), tag
    top = max(g.abs().max() for g in ref[1].values())
    for part in (1, 2):
        assert ref[part].keys() == got[part].keys()
        for k in ref[part]:
            if part == 1 and not grads_bitwise:
                g, r = got[part][k], ref[part][k]
                assert (g - r).abs().max() <= max(1e-5 * r.abs().max(), 1e-6 * top), (tag, k)
            else:
                assert torch.equal(ref[part][k], got[part][k]), (tag, k)


def test_memory_keys_leave_the_function():
    """remat_ffn on against off, and the whole-forward remat around both
    memory keys (the nested regions run as part of it): outputs, gradients
    and running statistics bitwise equal. tail_chunks 8 (8 chunks of one
    sample) against 1: outputs and running statistics bitwise equal, each
    gradient within 1e-5 of its tensor's largest value, with a floor of 1e-6
    of the largest gradient for those that are rounding noise of an exact
    zero (the query projection where one key is attended to; the JAX package
    holds its own chunked tail to rtol and atol 1e-5,
    tests/test_models_extended.py::test_changeformer_chunked_tail_exact):
    the chunks' backward sums each conv's weight gradient chunk by chunk
    and takes its input gradient one sample at a time, another order of the
    same f32 sums."""
    cfg = cdp.config("changeformer", batch=8)
    base = t_init(cfg, WIDTH, device="cpu", seed=4).state_dict()
    rs = np.random.RandomState(3)
    x = tuple(torch.from_numpy(rs.randn(8, 32, 32, 2).astype(np.float32)) for _ in range(2))
    masks = [rs.rand(8, 1, 1) < 0.95 for _ in range(48)]
    runs = {}
    for chunks, remat_ffn, remat in ((1, False, False), (1, True, False), (8, False, False),
                                     (8, True, True)):
        mcfg = dict(WIDTH, tail_chunks=chunks, remat_ffn=remat_ffn)
        model = t_init(cfg, mcfg, device="cpu").train()
        assert model.TDec_x2.chunk_count(8) == chunks
        runs[chunks, remat_ffn, remat] = _grads(cfg, mcfg, base, x, masks, remat)
    ref = runs[1, False, False]
    _assert_same(ref, runs[1, True, False], "remat_ffn")
    _assert_same(runs[8, False, False], runs[8, True, True], "whole-forward remat, tail chunks")
    _assert_same(ref, runs[8, False, False], "tail_chunks", grads_bitwise=False)


def test_auto_rules_match_jax():
    # the tail's chunks: 0 is 8 in training at b >= 64 with b % 8 == 0
    for b in (1, 2, 6, 8, 12, 60, 64, 128):
        for requested in (1, 3, 8, 16):
            assert tcf._tail_chunk_count(requested, b) == jcf._tail_chunk_count(requested, b)
    dec = tcf.DecoderTransformerV3(32, 3)
    assert [dec.train().chunk_count(b) for b in (32, 60, 64, 128)] == [1, 1, 8, 8]
    assert dec.eval().chunk_count(128) == 1
    assert tcf.DecoderTransformerV3(32, 3, tail_chunks=6).eval().chunk_count(128) == 4
    # remat_ffn "auto": B * N * dim * 4 >= 51e6 in training; at b128 and 224^2
    # stages 1 (3,136 tokens of 64) and 2 (784 of 128)
    tokens = {64: 3136, 128: 784, 320: 196, 512: 49}
    for b, want in ((128, [True, True, False, False]), (64, [True, False, False, False])):
        got = []
        for dim, n in tokens.items():
            block = tcf.EncoderBlock(dim, 1, 1, 0.0).train()
            got.append(block.uses_remat(torch.empty(b, n, 1).expand(b, n, dim)))
            assert not block.eval().uses_remat(torch.empty(b, n, 1).expand(b, n, dim))
        assert got == want
    forced = tcf.EncoderBlock(64, 1, 1, 0.0, remat_ffn=True).eval()
    assert forced.uses_remat(torch.empty(1, 1, 64))


def test_linear_schedule_matches_jax():
    mcfg = cdp.method_config("changeformer")
    assert mcfg["lr_schedule"] == "linear"
    for epochs in (1, 5):
        t, j = t_schedule({"epochs": epochs}, mcfg, 4), j_schedule({"epochs": epochs}, mcfg, 4)
        assert [t(e) for e in range(epochs)] == pytest.approx([j(e) for e in range(epochs)],
                                                              rel=1e-12)


@pytest.mark.parametrize("hw,size", [((8, 8), (32, 32)), ((1, 1), (32, 32)), ((4, 6), (9, 13)),
                                     ((32, 32), (8, 8)), ((12, 10), (5, 7))],
                         ids=["head-4x", "head-1px", "odd-up", "down-4x", "odd-down"])
def test_resize_linear_matches_jax_image_resize(hw, size):
    """The multi-scale loss's resize: jax.image.resize's "bilinear" (half
    pixel centres; antialiased when it shrinks), on a head smaller than the
    mask and the other way."""
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    got = tnn.resize_linear(torch.from_numpy(x), size).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 3), "bilinear"))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_drop_path_mask_and_scale():
    dp = tnn.DropPath(0.25).train()
    x = torch.ones(6, 5, 3)
    mask = dp.draw_mask(x, torch.Generator().manual_seed(0))
    assert mask.shape == (6, 1, 1) and mask.dtype == torch.bool
    with cdp.fed_masks([mask], tnn.DropPath):
        y = dp(x)
    want = np.where(mask.numpy(), np.float32(1) / np.float32(0.75), np.float32(0)) * np.ones(
        x.shape, np.float32)
    np.testing.assert_array_equal(y.numpy(), want)
    assert dp.eval()(x) is x and tnn.DropPath(0.0).train()(x) is x


def test_list_output_through_the_step_remat_and_eval_microbatch():
    """The five heads through the train step's whole-forward remat (bitwise
    the step without it) and through the eval step's microbatches (the
    same bank; the loss the mean of the chunks')."""
    from kurosiwo_torch.ops.losses import create_loss
    from kurosiwo_torch.ops.metrics import MetricState
    from kurosiwo_torch.training.state import create_train_state
    from kurosiwo_torch.training.steps import make_eval_step, make_train_step

    cfg = cdp.step_config("changeformer")
    mcfg = cdp.method_config("changeformer", **WIDTH)
    base = t_init(cfg, mcfg, device="cpu", seed=2).state_dict()
    batch = cdp.step_batch("changeformer", 0)
    after = {}
    for remat in (False, True):
        c = dict(cfg, remat=remat)
        model = t_init(c, mcfg, device="cpu")
        model.load_state_dict(base)
        step = make_train_step(model, create_loss(c, "train"), c, mcfg, task="cd", device="cpu")
        _, ms, loss = step(create_train_state(model, c, mcfg, "cd"), batch, MetricState.create(),
                           cdp.LR, torch.Generator().manual_seed(5))
        after[remat] = (float(loss), ms.cm.clone(), model.state_dict())
    assert after[False][0] == after[True][0] and torch.equal(after[False][1], after[True][1])
    assert all(torch.equal(v, after[True][2][k]) for k, v in after[False][2].items())
    ev = {micro: make_eval_step(model, create_loss(c, "val"), dict(c, eval_microbatch=micro),
                                mcfg, task="cd", device="cpu") for micro in (0, 1)}
    whole, _, _ = ev[0](None, batch, MetricState.create())
    chunked, loss, _ = ev[1](None, batch, MetricState.create())
    singles = [ev[0](None, {k: v[i:i + 1] for k, v in batch.items()}, MetricState.create())[1]
               for i in range(2)]
    assert torch.equal(whole.cm, chunked.cm)
    assert float(loss) == float(torch.stack(singles).mean())
