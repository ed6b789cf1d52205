"""remat (kurosiwo_torch.ops.remat) in the port's train steps: SNUNet's
per-block and per-column plan, and the whole-forward region of every other
method (Siam-diff with its dropout masks drawn from the step's generator,
ADHR-CDNet, the segmentation UNet), each step with remat on against the
same step with it off, from the same weights, batch and generator seed.

Exactness class (ROADMAP C5): bit-exact within torch. The recompute
normalizes with the statistics the first forward reduced and applies the
masks it drew, so the loss, the parameters and Adam's moments after the
step, and the BatchNorm running statistics (updated once, as
``jax.checkpoint`` discards the recompute's mutations) are equal bitwise;
the pair-sum reductions of a step are as many as without remat (with
SNUNet's ``snunet_save_bn_stats`` off, the recompute reduces again: more
reductions, the same numbers).
"""

import copy

import numpy as np
import pytest
import torch

import torch_cd_parity as cdp
from kurosiwo_torch.bench import MODEL_CONFIG, build_config
from kurosiwo_torch.models.factory import initialize_segmentation_model
from kurosiwo_torch.ops import batchnorm
from kurosiwo_torch.ops.losses import create_loss
from kurosiwo_torch.ops.metrics import MetricState
from kurosiwo_torch.training.state import create_train_state
from kurosiwo_torch.training.steps import make_train_step

torch.set_num_threads(2)

# (method, config overrides, pair-sum reductions of a step without remat;
# with remat: the same, or the second number). SNUNet: 9 encoder block
# calls and 10 decoder nodes of 2 BatchNorms; Siam: 10 encoder convs a
# frame and 9 decoder convs; each forward reduction has its backward one.
CASES = [
    ("snunet", {}, 76, 76),
    ("snunet", {"snunet_save_bn_stats": False}, 76, 114),
    ("siam-diff", {}, 58, 58),
    ("adhr-cdnet", {}, None, None),
    ("unet", {}, 60, 60),
]


def _batch(size: int, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    b = {k: rs.randn(2, size, size, 2).astype(np.float32) for k in ("post", "pre1", "pre2")}
    b["mask"] = rs.randint(0, 4, (2, size, size)).astype(np.int32)
    return b


def _step_once(model, cfg, mcfg, task, batch, calls):
    model = copy.deepcopy(model)
    state = create_train_state(model, cfg, mcfg, task)
    step = make_train_step(model, create_loss(cfg, "train"), cfg, mcfg, task=task, device="cpu")
    calls.clear()
    state, _, loss = step(state, batch, MetricState.create(), 1e-3,
                          torch.Generator().manual_seed(11))
    moments = [state.optimizer.state[p]["exp_avg"] for p in model.parameters()]
    return loss, model.state_dict(), moments, len(calls)


@pytest.mark.parametrize("method,extra,plain_calls,remat_calls", CASES,
                         ids=["snunet", "snunet-stats-recomputed", "siam-diff", "adhr-cdnet",
                              "unet"])
def test_remat_step_equals_the_plain_step(monkeypatch, method, extra, plain_calls, remat_calls):
    calls = []
    real = batchnorm.pair_sums
    monkeypatch.setattr(batchnorm, "pair_sums", lambda a, b: calls.append(1) or real(a, b))
    if method == "unet":
        task, cfg, mcfg = "segmentation", dict(build_config("unet", 2), mixed_precision=False), \
            MODEL_CONFIG
        model = initialize_segmentation_model(cfg, mcfg, device="cpu", seed=1)
        size = 32
    else:
        task, mcfg = "cd", dict(cdp.MCFG, optimizer="adam")
        cfg = cdp.config(method, loss_function="cross_entropy", class_weights=[1.0, 1.0, 1.0],
                         **extra)
        model = cdp.t_init(cfg, mcfg, device="cpu", seed=1)
        size = cdp.SIZES[method]
    batch = _batch(size)
    runs = {}
    for remat in (False, True):
        c = dict(cfg, remat=remat)
        if method == "snunet":
            model.remat = remat  # the factory's wiring of c["remat"]
        runs[remat] = _step_once(model, c, mcfg, task, batch, calls)
    (loss0, sd0, m0, n0), (loss1, sd1, m1, n1) = runs[False], runs[True]
    assert float(loss0) == float(loss1)
    assert sd0.keys() == sd1.keys()
    for k in sd0:  # parameters and running statistics
        assert torch.equal(sd0[k], sd1[k]), k
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))
    if plain_calls is not None:
        assert (n0, n1) == (plain_calls, remat_calls)
    else:
        assert n0 == n1


def test_remat_runs_the_forward_again_in_the_backward(monkeypatch):
    """The region's forward does run twice (the first time, and in the
    backward pass), and the recompute updates no running statistic."""
    forwards = []
    cfg = cdp.config("siam-diff", loss_function="cross_entropy", class_weights=[1.0, 1.0, 1.0],
                     remat=True)
    model = cdp.t_init(cfg, {}, device="cpu", seed=1)
    real = type(model).forward
    monkeypatch.setattr(type(model), "forward",
                        lambda self, *a, **k: forwards.append(1) or real(self, *a, **k))
    updates = []
    real_update = batchnorm.BatchNorm.update_running

    def counting(self, m, v):  # counts the calls that moved the running mean
        before = self.mean.clone()
        real_update(self, m, v)
        if not torch.equal(before, self.mean):
            updates.append(1)

    monkeypatch.setattr(batchnorm.BatchNorm, "update_running", counting)
    state = create_train_state(model, cfg, {})
    step = make_train_step(model, create_loss(cfg, "train"), cfg, {}, task="cd", device="cpu")
    step(state, _batch(36), MetricState.create(), 1e-3, torch.Generator().manual_seed(0))
    assert len(forwards) == 2 and len(updates) == 29
