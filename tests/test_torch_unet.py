"""Port parity: kurosiwo_torch.models.unet.UNet (ResNet-18 encoder, standard
decoder) against kurosiwo_tpu.models.unet.UNet with ``phase_finale`` on and
off, the same weights carried through kurosiwo_torch.convert.

Cross-framework f32 on the CPU, the model zoo's parity band: logits and
updated batch statistics atol 5e-4. The weight bridge is bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.convert import flax_to_torch, torch_to_flax
from kurosiwo_torch.models.unet import UNet as TorchUNet
from kurosiwo_tpu.models.unet import UNet as JaxUNet

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SHAPE = (2, 64, 64, 6)


def _perturbed_variables(backbone="resnet18", seed=0):
    """JAX UNet variables with non-trivial BatchNorm affine and statistics."""
    x = jnp.zeros(SHAPE, jnp.float32)
    v = jax.jit(JaxUNet(num_classes=3, backbone=backbone).init)(jax.random.PRNGKey(seed), x)
    rs = np.random.RandomState(seed)

    def perturb(path, leaf):
        name = path[-1].key
        a = np.asarray(leaf)
        if name == "scale":
            return (1.0 + 0.2 * rs.randn(*a.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rs.randn(*a.shape)).astype(np.float32)
        if name == "var":
            return (1.0 + 0.5 * rs.rand(*a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, jax.tree.map(np.asarray, dict(v)))


@pytest.fixture(scope="module")
def setup():
    v = _perturbed_variables()
    x = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    model = TorchUNet(in_channels=6, num_classes=3)
    model.load_state_dict(flax_to_torch(v))
    return v, x, model


@pytest.mark.parametrize("phase_finale", [True, False])
def test_eval_logits_match_jax(setup, phase_finale):
    v, x, model = setup
    jy = JaxUNet(num_classes=3, phase_finale=phase_finale).apply(v, jnp.asarray(x), train=False)
    model.eval()
    with torch.no_grad():
        ty = model(torch.from_numpy(x))
    assert ty.shape == (2, 64, 64, 3) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-4)


@pytest.mark.parametrize("phase_finale", [True, False])
def test_train_logits_and_batch_stats_match_jax(setup, phase_finale):
    v, x, _ = setup
    jy, upd = JaxUNet(num_classes=3, phase_finale=phase_finale).apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = TorchUNet(in_channels=6, num_classes=3)
    model.load_state_dict(flax_to_torch(v))
    model.train()
    with torch.no_grad():
        ty = model(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-4)
    got = torch_to_flax(model.state_dict())["batch_stats"]
    want = jax.tree.map(np.asarray, dict(upd["batch_stats"]))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=5e-4)


def test_bf16_policy_keeps_f32_params_and_bf16_logits(setup):
    _, x, model = setup
    model.eval()
    with torch.no_grad():
        y = model(torch.from_numpy(x), dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_flax_torch_round_trip_is_bit_exact(setup):
    v, _, _ = setup
    back = torch_to_flax(flax_to_torch(v))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(dict(v))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(dict(v))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("backbone", ["resnet18", "resnet34"])
def test_state_dict_names_and_shapes_match_flax_tree(backbone):
    shapes = jax.eval_shape(
        lambda: JaxUNet(num_classes=3, backbone=backbone).init(
            jax.random.PRNGKey(0), jnp.zeros(SHAPE, jnp.float32)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    want = {k: tuple(t.shape) for k, t in flax_to_torch(zeros).items()}
    model = TorchUNet(in_channels=6, num_classes=3, backbone=backbone)
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == want
    n_bn = sum(k.endswith("BatchNorm_0.scale") for k in got)
    assert n_bn == (30 if backbone == "resnet18" else 46)
