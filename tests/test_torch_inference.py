"""Port parity of scene inference: kurosiwo_torch.inference against
kurosiwo_tpu.inference on the CPU (the single-device functions).

  * sliding-window blending and its edge cases with a fake model whose
    logits favour class round(mean of the window), the cases of
    tests/test_inference.py;
  * the real UNet-ResNet18 scene (64x64 tiles, 2 channels), the same weights
    carried over by ``convert.flax_to_torch``: blended logits atol 5e-4 (the
    model zoo's cross-framework f32 band, ROADMAP C5), class maps equal
    wherever the top two blended logits are more than 1e-3 apart;
  * ``interpolate_pos_embedding`` against ``jax.image.resize`` (linear,
    antialiased when it downsamples) within 1e-6;
  * ``vit_whole_scene`` in f32 at a small width against JAX's within 5e-4:
    a 64x64 scene (16 tokens, einsum attention) and a 512x512 one at patch
    16 (1,024 tokens, the flash route; JAX's flash kernel in interpret mode,
    as tests/test_torch_flash_attention.py explains).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch import inference as tinf
from kurosiwo_torch.convert import flax_to_torch
from kurosiwo_torch.models.factory import initialize_segmentation_model as t_init_seg
from kurosiwo_torch.models.vit import ViT as TViT
from kurosiwo_tpu import inference as jinf
from kurosiwo_tpu.models.factory import initialize_segmentation_model as j_init_seg
from kurosiwo_tpu.models.vit import ViT as JViT
from kurosiwo_tpu.ops import pallas_attention as jpa

torch.set_num_threads(2)


class _ConstModel(torch.nn.Module):
    """Logits favour class round(mean of the window): 0, mean, -mean."""

    def forward(self, x):
        b, h, w, _ = x.shape
        m = x.mean(dim=(1, 2, 3))
        logits = torch.stack([torch.zeros_like(m), m, -m], dim=-1)
        return logits[:, None, None, :].expand(b, h, w, 3)


class _JaxConstModel:
    def apply(self, variables, x, train=False):
        b = x.shape[0]
        m = jnp.mean(x, axis=(1, 2, 3))
        logits = jnp.stack([jnp.zeros_like(m), m, -m], axis=-1)
        return jnp.broadcast_to(logits[:, None, None, :], (b, x.shape[1], x.shape[2], 3))


def _pred(tile, batch_size):
    return tinf.TilePredictor(_ConstModel(), tile=tile, batch_size=batch_size, device="cpu")


def test_predict_scene_shapes_and_blend():
    scene = np.ones((150, 200, 2), np.float32)  # mean 1 -> class 1 wins
    mask = tinf.predict_scene(_pred(64, 4), scene, overlap=16)
    assert mask.shape == (150, 200) and mask.dtype == np.uint8
    assert (mask == 1).all()


def test_predict_scene_smaller_than_tile():
    scene = -np.ones((40, 50, 2), np.float32)  # mean -1 -> class 2 wins
    mask = tinf.predict_scene(_pred(64, 2), scene, overlap=16)
    assert mask.shape == (40, 50)
    assert (mask == 2).all()


def test_tile_predictor_ragged_batch():
    """7 tiles in batches of 4: the last batch is padded by repeating its
    last tile, and the padding is dropped."""
    seen = []

    class Recording(_ConstModel):
        def forward(self, x):
            seen.append(x.shape[0])
            return super().forward(x)

    pred = tinf.TilePredictor(Recording(), tile=32, batch_size=4, device="cpu")
    tiles = np.random.RandomState(0).rand(7, 32, 32, 2).astype(np.float32)
    logits = pred.predict_logits(tiles)
    assert seen == [4, 4] and logits.shape == (7, 32, 32, 3) and logits.dtype == np.float32
    assert pred.predict(tiles).shape == (7, 32, 32)
    np.testing.assert_allclose(logits[:, 0, 0, 1], tiles.mean(axis=(1, 2, 3)), rtol=1e-6)


def test_predict_scene_much_smaller_than_tile():
    """pad > dim - 1 (reflect's cap): symmetric multi-pass padding covers it."""
    scene = np.random.RandomState(3).rand(20, 20, 2).astype(np.float32)
    mask = tinf.predict_scene(_pred(64, 2), scene, overlap=16)
    assert mask.shape == (20, 20)


def test_predict_scene_rejects_bad_overlap():
    scene = np.zeros((100, 100, 2), np.float32)
    with pytest.raises(ValueError, match="overlap"):
        tinf.predict_scene(_pred(64, 2), scene, overlap=64)
    with pytest.raises(ValueError, match="overlap"):
        tinf.predict_scene(_pred(64, 2), scene, overlap=300)


@pytest.mark.parametrize("shape,overlap", [((150, 200, 2), 16), ((20, 20, 2), 16),
                                           ((97, 61, 2), 0), ((130, 130, 2), 40)])
def test_predict_scene_blending_matches_jax(shape, overlap):
    """The same windows, padding and blending as the JAX package, down to
    the class map, for a model whose logits vary from window to window."""
    scene = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = jinf.predict_scene(jinf.TilePredictor(_JaxConstModel(), {}, tile=64, batch_size=3),
                              scene, overlap=overlap)
    got = tinf.predict_scene(_pred(64, 3), scene, overlap=overlap)
    np.testing.assert_array_equal(got, want)


def test_load_variables_missing_checkpoint_raises(base_config):
    model = t_init_seg(dict(base_config), {"backbone": "resnet18"}, device="cpu")
    with pytest.raises(FileNotFoundError):
        tinf.load_variables("/nonexistent/ckpt_typo", model)


def test_load_variables_routes(base_config, tmp_path):
    """"" is the model's own seeded initialisation; ``dir/name`` the port's
    own checkpoint (A11, ported); a reference torch .pt goes through the
    method's converter (A13, ported), the model's BatchNorm statistics kept
    where the file has none; an orbax directory (the JAX package's format)
    is refused, saying why."""
    from kurosiwo_torch.training.checkpoint import CheckpointManager
    from kurosiwo_torch.training.state import create_train_state

    model = t_init_seg(dict(base_config), {"backbone": "resnet18"}, device="cpu")
    state = tinf.load_variables("", model)
    assert state.keys() == model.state_dict().keys()
    trained = t_init_seg(dict(base_config), {"backbone": "resnet18"}, device="cpu", seed=5)
    CheckpointManager(tmp_path / "run").save_best(
        create_train_state(trained, base_config, {}), 0, 1.0)
    loaded = tinf.load_variables(str(tmp_path / "run" / "best_segmentation"), model)
    assert loaded.keys() == model.state_dict().keys()
    for k, v in trained.state_dict().items():
        assert torch.equal(loaded[k], v), k
    import torch_ref_layout as ref
    from kurosiwo_torch import convert as tconv

    channels = model.encoder.stem.Conv_0.weight.shape[1]
    shapes = ref.jax_shapes(j_init_seg(dict(base_config, num_channels=channels),
                                       {"backbone": "resnet18"}),
                            jnp.zeros((1, 32, 32, channels)), train=False)
    pt = tmp_path / "model.pt"
    torch.save({k: torch.from_numpy(v) for k, v in
                ref.reference_state(shapes, ref.SMP_UNET, 0).items()}, pt)
    loaded = tinf.load_variables(str(pt), model, "unet")
    want = tconv.convert(pt, "unet")
    assert loaded.keys() == want.keys() == model.state_dict().keys()
    for k, v in want.items():
        assert torch.equal(loaded[k], v), k
    model.load_state_dict(loaded)
    vit = tmp_path / "floodvit.pt"
    torch.save({"weight": torch.zeros(1)}, vit)
    with pytest.raises(KeyError, match="no converter for 'unet\\+\\+'"):
        tinf.load_variables(str(vit), model, "unet++")
    with pytest.raises(NotImplementedError, match="orbax.*JAX"):
        tinf.load_variables(str(tmp_path), model)


# ------------------------------------------------------------ real UNet scene


def test_real_unet_scene_matches_jax(base_config):
    cfg = dict(base_config, num_channels=2)
    mcfg = {"backbone": "resnet18"}
    jmodel = j_init_seg(cfg, mcfg)
    variables = jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, 64, 64, 2)), train=False))(
        jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, dict(variables))
    jpred = jinf.TilePredictor(jmodel, variables, tile=64, batch_size=2)
    tmodel = t_init_seg(cfg, mcfg, device="cpu")
    tmodel.load_state_dict(flax_to_torch(variables))
    tpred = tinf.TilePredictor(tmodel, tile=64, batch_size=2, device="cpu")
    scene = np.random.RandomState(0).rand(100, 130, 2).astype(np.float32)

    # the same blending over either package's tile logits
    logits = tinf.blend_scene(tpred, scene, overlap=16)
    np.testing.assert_allclose(logits, tinf.blend_scene(jpred, scene, overlap=16), atol=5e-4,
                               rtol=0)
    want = jinf.predict_scene(jpred, scene, overlap=16)
    got = tinf.predict_scene(tpred, scene, overlap=16)
    assert got.shape == (100, 130) and set(np.unique(got)) <= {0, 1, 2}
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 1e-3
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got[decided], want[decided])



# ------------------------------------------------------------ whole-scene ViT


@pytest.mark.parametrize("grid", [(64, 64), (5, 6), (20, 9)])
def test_interpolate_pos_embedding_matches_jax_resize(grid):
    """14x14 learned grid to a scene's grid: up (64x64), down (5x6, where the
    JAX resize antialiases) and mixed (20x9)."""
    pos = np.random.RandomState(1).randn(1, 1 + 14 * 14, 8).astype(np.float32)
    want = np.asarray(jinf.interpolate_pos_embedding(jnp.asarray(pos), grid))
    got = tinf.interpolate_pos_embedding(torch.from_numpy(pos), grid)
    assert got.shape == (1, grid[0] * grid[1], 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


DIMS = dict(patch_size=16, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)


@pytest.fixture(scope="module")
def vit_pair():
    """The JAX ViT's encoder parameters and the port's ViT holding them."""
    jmodel = JViT(image_size=64, channels=2, pool="cls", dtype=jnp.float32, **DIMS)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 2)))["params"]
    params = jax.tree.map(np.asarray, dict(params))
    tmodel = TViT(image_size=64, channels=2, pool="cls", **DIMS)
    tmodel.load_state_dict(flax_to_torch({"params": params}))
    return params, tmodel


@pytest.mark.parametrize("size", [64, 512])
def test_vit_whole_scene_matches_jax(vit_pair, size, monkeypatch):
    """16 tokens (einsum attention) and 1,024 tokens (the flash route, JAX's
    kernel in interpret mode), f32."""
    params, tmodel = vit_pair
    calls = []
    orig = jpa.flash_attention
    monkeypatch.setattr(jpa, "flash_attention", lambda q, k, v, s, bq, bk: calls.append(1)
                        or orig(q, k, v, s, bq, bk, True))
    scene = np.random.RandomState(size).randn(size, size, 2).astype(np.float32)
    want = np.asarray(jinf.vit_whole_scene(params, scene, dtype=jnp.float32, **DIMS))
    got = tinf.vit_whole_scene(tmodel, scene, dtype=torch.float32, device="cpu")
    n = (size // 16) ** 2
    assert got.shape == want.shape == (1, n, 64) and got.dtype == torch.float32
    assert len(calls) == (DIMS["depth"] if n >= 1024 else 0)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


def test_vit_whole_scene_pads_a_ragged_scene(vit_pair):
    """70x90 reflect-pads to 80x96: a 5x6 grid of 30 tokens, the model's
    4x4 learned positions resampled to it."""
    _, tmodel = vit_pair
    feats = tinf.vit_whole_scene(tmodel, np.zeros((70, 90, 2), np.float32), dtype=torch.float32,
                                 device="cpu")
    assert feats.shape == (1, 5 * 6, DIMS["dim"])
    assert torch.isfinite(feats).all()
