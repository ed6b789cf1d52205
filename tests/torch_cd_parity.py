"""What the port's change-detection parity tests share: the models' tiny
configs, seeded weights (the port's init, with perturbed BatchNorm affine
and statistics) as both a torch ``state_dict`` and flax variables, and the
Dropout2d masks JAX draws, recorded and fed to the port (the port cannot
replay ``make_rng("dropout")``'s stream; ROADMAP C16)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import torch_to_flax
from kurosiwo_torch.models.factory import initialize_cd_model as t_init
from kurosiwo_torch.ops import nn as tnn
from kurosiwo_tpu.models.factory import initialize_cd_model as j_init
from kurosiwo_tpu.ops import nn as jnn

# method -> the square input side its tiny parity runs use: SNUNet and ADHR
# need multiples of 16 and 8; 36 makes Siam's replication pad act (36 -> 18
# -> 9 -> 4 -> 2, upsampled to 4, 8, 18, 36); HFA-Net fits 224 only
SIZES = {"snunet": 32, "siam-diff": 36, "siam-conc": 36, "adhr-cdnet": 32, "hfa-net": 224}
MCFG = {"base_channel": 8}  # SNUNet's width, cut from 32; the other models have no width key


def config(method: str, batch: int = 2, **kw) -> dict:
    return {"task": "cd", "method": method, "num_classes": 3, "num_channels": 2,
            "mixed_precision": False, "batch_size": batch, "remat": False,
            "inputs": ["pre_event_1", "post_event"], "dem": False, **kw}


def frames(method: str, batch: int = 2, seed: int = 0):
    rs = np.random.RandomState(seed)
    s = SIZES[method]
    return (rs.randn(batch, s, s, 2).astype(np.float32),
            rs.randn(batch, s, s, 2).astype(np.float32))


def variables(method: str, seed: int = 0) -> dict:
    """Flax variables from the port's seeded init, BatchNorm scale, bias,
    mean and var perturbed so that the eval path is not an identity."""
    model = t_init(config(method), MCFG, device="cpu", seed=seed)
    v = torch_to_flax(model.state_dict())
    rs = np.random.RandomState(seed + 100)

    def walk(node, stats):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, stats)
            elif name == "scale" or (stats and name == "var"):
                node[name] = (1.0 + (0.2 * rs.randn(*leaf.shape) if name == "scale"
                                     else 0.5 * rs.rand(*leaf.shape))).astype(np.float32)
            elif (name == "bias" and "scale" in node) or (stats and name == "mean"):
                node[name] = (0.1 * rs.randn(*leaf.shape)).astype(np.float32)

    walk(v["params"], False)
    walk(v["batch_stats"], True)
    return v


def jax_model(method: str, **kw):
    return j_init(config(method, **kw), MCFG)


@contextlib.contextmanager
def recorded_jax_masks():
    """JAX's Dropout2d with each mask it draws appended to the yielded list
    (run the JAX apply eagerly so that the masks are concrete)."""
    masks = []

    def recording(self, x, deterministic=True):
        if deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep,
                                    shape=(x.shape[0], 1, 1, x.shape[-1]))
        masks.append(np.asarray(mask))
        return jnp.where(mask, x / keep, 0.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn.Dropout2d, "__call__", recording)
        yield masks


@contextlib.contextmanager
def fed_masks(masks):
    """The port's Dropout2d draws ``masks`` in order; all of them must be
    used."""
    it = iter(list(masks))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnn.Dropout2d, "draw_mask",
                   lambda self, x, g: torch.from_numpy(np.array(next(it))))
        yield
    assert next(it, None) is None, "the port drew fewer masks than JAX"


def tree(x):
    return jax.tree.map(np.asarray, dict(x))


def assert_gradients_close(got, want, rel: float = 5e-2, floor: float = 1e-6):
    """torch_step_parity.assert_first_moment_close's bands (each tensor
    within ``rel``, 5%, of its largest value, all within 2% in L2), with a
    floor for
    the tensors whose gradient is zero in exact arithmetic: a conv bias that
    feeds a train-mode BatchNorm alone (SNUNet's conv2, for one) has a
    gradient of rounding noise in both frameworks (1e-13 to 1e-8 here,
    against 5e-2 for the largest gradient), which no relative band can hold.
    Such a tensor is held within ``floor`` (1e-6) of the tree's largest
    gradient."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    leaves = list(zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    floor = floor * max(np.abs(w).max() for _, w in leaves)
    num = den = 0.0
    for g, w in leaves:
        assert np.abs(g - w).max() <= max(rel * np.abs(w).max(), floor)
        num += float(np.square(g - w).sum())
        den += float(np.square(w).sum())
    assert np.sqrt(num / den) <= 2e-2
