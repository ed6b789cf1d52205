"""The engine's card paths: device_prefetch's uploads (from the Loader's
page-locked ring, or staged for other batches) on its copy stream,
one engine epoch on the card against the same epoch on the CPU, and a
checkpoint round trip of card tensors.

Marked ``cuda``: each test skips where no CUDA device is available (decided
inside the fixture). On the card's machine (no JAX, so without the
repository conftest): ``python -m pytest tests/test_torch_cuda_engine.py -q
--noconftest``.

Exactness classes (ROADMAP C5): uploads and checkpoint round trips
bit-exact; the card's epoch against the CPU's cross-device banded as the
engine's JAX parity (tests/test_torch_engine.py): bank row sums equal, cells
within 1% of the valid pixels, mean losses within rtol 5e-3 (Adam's
near-ties, C6).
"""

import copy

import numpy as np
import pytest
import torch

from kurosiwo_torch.data.pipeline import Loader
from kurosiwo_torch.models.factory import initialize_segmentation_model
from kurosiwo_torch.ops import batchnorm, fused_tail
from kurosiwo_torch.training.checkpoint import CheckpointManager
from kurosiwo_torch.training.engine import TaskEngine, device_prefetch
from kurosiwo_torch.training.steps import STEP_KEYS

pytestmark = pytest.mark.cuda

MCFG = {"backbone": "resnet18", "learning_rate": 1e-3, "lr_schedule": "cosine",
        "optimizer": "adam"}
CFG = {
    "task": "segmentation", "method": "unet", "root_path": "/nonexistent-kuro-siwo",
    "num_classes": 3, "mixed_precision": False, "batch_size": 4, "num_workers": 2,
    "print_frequency": 1000, "log_AOI_metrics": True, "loss_function": "cross_entropy",
    "track": "RandomEvents", "inputs": ["pre_event_1", "pre_event_2", "post_event"],
    "channels": ["vv", "vh"], "clamp_input": 0.15, "scale_input": "normalize",
    "data_mean": [0.0953, 0.0264], "data_std": [0.0427, 0.0215], "synthetic_data": True,
    "synthetic_size": 10, "synthetic_patch_size": 32, "train_acts": [130, 470],
    "val_acts": [514, 559, 279], "test_acts": [321], "class_weights": [1.0, 1.0, 1.0],
    "num_channels": 6,
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_uploads_every_batch_intact(dev, depth):
    rs = np.random.RandomState(depth)
    host = [{"post": rs.randn(4, 64, 64, 2).astype(np.float32),
             "mask": rs.randint(0, 4, (4, 64, 64)).astype(np.int32),
             "sample_weight": np.ones(4, np.float32),
             "activation": np.arange(4, dtype=np.int32) + i} for i in range(7)]
    got = []
    for batch in device_prefetch(host, dev, depth=depth):
        torch.cuda._sleep(int(5e6))  # the compute stream lags the copy stream
        got.append({k: v.clone() if torch.is_tensor(v) else v for k, v in batch.items()})
    torch.cuda.synchronize()
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert g.keys() == h.keys()
        for k in ("post", "mask", "sample_weight"):
            assert g[k].device.type == "cuda" and g[k].dtype == torch.from_numpy(h[k]).dtype
            np.testing.assert_array_equal(g[k].cpu().numpy(), h[k])
        assert g["activation"] is h["activation"]  # stays on the host


def test_device_prefetch_uploads_the_loaders_ring_in_place(dev):
    """A Loader's batches go up from its page-locked ring (no host copy):
    every batch on the card equals the same epoch read on the host, the
    non-step keys stay on the host as copies, and the ring's 3 slots serve
    the 3 batches of an epoch twice over while the compute stream lags."""
    cfg = dict(CFG, synthetic_size=22, batch_size=2)
    want = [list(Loader("val", cfg, 5)) for _ in range(2)]
    loader = Loader("val", cfg, 5)
    for epoch in range(2):
        got = []
        for batch in device_prefetch(loader, dev):
            torch.cuda._sleep(int(2e6))
            got.append({k: v.clone() if torch.is_tensor(v) else v for k, v in batch.items()})
        torch.cuda.synchronize()
        assert len(got) == len(want[epoch]) == 11
        for g, w in zip(got, want[epoch]):
            assert g.keys() == w.keys()
            for k, v in w.items():
                if k not in STEP_KEYS:
                    assert isinstance(g[k], np.ndarray)
                    np.testing.assert_array_equal(g[k], v)
                else:
                    assert g[k].device.type == "cuda"
                    np.testing.assert_array_equal(g[k].cpu().numpy(), v)
    assert loader._ring is not None and len(loader._ring.raws) == 3 and loader._ring._pinned
    loader.close()


def _engine_epoch(model, device):
    train = Loader("train", CFG, 3)
    engine = TaskEngine(model, CFG, MCFG, "segmentation", steps_per_epoch=len(train),
                        device=device)
    summary = engine.run_train_epoch(train, 0)
    _, _, _, val = engine.run_eval(Loader("val", CFG, 3), "Val")
    return engine, summary, val


def test_engine_epoch_on_the_card_matches_the_cpu(dev, tmp_path):
    cpu_model = initialize_segmentation_model(CFG, MCFG, device="cpu", seed=4)
    card_model = copy.deepcopy(cpu_model).to(dev)
    pair0, fwd0 = batchnorm.pair_sums.launches, fused_tail.ce_cm_fwd_nhwc.launches
    card, card_train, card_val = _engine_epoch(card_model, dev)
    assert batchnorm.pair_sums.launches - pair0 == 60 * 2
    assert fused_tail.ce_cm_fwd_nhwc.launches - fwd0 == 2 + 2 * 3
    _, cpu_train, cpu_val = _engine_epoch(cpu_model, "cpu")
    for got, want in ((card_train, cpu_train), (card_val, cpu_val)):
        np.testing.assert_array_equal(got["cm"].sum(axis=1), want["cm"].sum(axis=1))
        assert np.abs(got["cm"] - want["cm"]).max() <= 1e-2 * want["cm"].sum()
        np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=5e-3)
    assert sorted(card_val["aoi_banks"]) == sorted(cpu_val["aoi_banks"])

    # a checkpoint of card tensors restores bitwise on the card, Adam's step
    # counts on the host
    ckpt = CheckpointManager(tmp_path, dev)
    ckpt.save("latest", card.state)
    want = {k: v.clone() for k, v in card.model.state_dict().items()}
    moments = {i: {k: v.clone() for k, v in s.items()}
               for i, s in card.state.optimizer.state_dict()["state"].items()}
    with torch.no_grad():
        for p in card.model.parameters():
            p.zero_()
    ckpt.restore("latest", card.state)
    for k, v in card.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for i, s in card.state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            assert v.device.type == ("cpu" if k == "step" else "cuda")
            assert torch.equal(v, moments[i][k])
