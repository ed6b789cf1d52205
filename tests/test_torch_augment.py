"""The port's batched augmentations (kurosiwo_torch.data.augment) against the
JAX package's (kurosiwo_tpu.data.augment). torch cannot reproduce
``jax.random``'s stream, so each test recovers the draws JAX's functions
make from their keys (the same key splits) and feeds them to the port's
applies.

Exactness classes (ROADMAP C5): flips, noise, cutout, the crop's masks and
the discard rule bit-exact; the crop's and the blur's images
cross-framework banded in f32 (atol 5e-4, C5's band: XLA's CPU arithmetic
gives the crop's weights a few ulps off the same f32 formula's, about 4e-6,
so an output moves by about 1e-5); the elastic warp's images atol 1e-4 and
masks equal but at sampling points that round the other way (at most 0.2%
of pixels): its affine is solved by LAPACK in JAX and by Cramer's rule in
the port, which moves the sampling points by about 1e-5 pixels at the
offsets used here (a tenth of the image, as the shipped 50 is to 224; an
affine that folds the image is ill-conditioned and moves them more).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kurosiwo_torch.data import augment as ta
from kurosiwo_tpu.data import augment as ja

SHIPPED = json.loads(
    (pathlib.Path(__file__).resolve().parent.parent / "configs" / "augmentations"
     / "augmentation.json").read_text())["augmentations"]
EVERY = {  # every operation at p = 1, the crop to the input's size
    "RandomResizedCrop": {"value": 40, "scale": [0.2, 1.0], "p": 1.0},
    "GaussianBlur": {"sigma_limit": [0.1, 2.0], "p": 1.0},
    "HorizontalFlip": {"p": 1.0},
    "VerticalFlip": {"p": 1.0},
    "ElasticTransform": {"alpha": "1.0", "sigma": 50, "alpha_affine": 9, "p": 1.0},
    "GaussNoise": {"p": 1.0},
    "MultNoise": {"p": 1.0},
    "Cutout": {"p": 1.0},
}


def _batch(b=3, size=40, seed=0, channels=2):
    rs = np.random.RandomState(seed)
    batch = {k: rs.randn(b, size, size, channels).astype(np.float32)
             for k in ("post", "pre1", "pre2")}
    batch["mask"] = rs.randint(0, 4, (b, size, size)).astype(np.int32)
    batch["valid"] = (rs.rand(b, size, size) > 0.1).astype(np.int32)
    return batch


def _t(x):
    return torch.from_numpy(np.array(x))


# -- the draws of each JAX operation, recovered from its key ----------------------

def j_crop_draws(key, b, h, w, scale, p=1.0):
    y0, x0, ch, cw = ja._sample_crop_boxes(key, b, h, w, scale)
    if p < 1.0:
        apply = jax.random.bernoulli(jax.random.fold_in(key, 7), p, (b,))
        y0, x0 = jnp.where(apply, y0, 0), jnp.where(apply, x0, 0)
        ch, cw = jnp.where(apply, ch, h), jnp.where(apply, cw, w)
    return {"y0": _t(y0), "x0": _t(x0), "ch": _t(ch), "cw": _t(cw)}


def j_flip_draws(key, b, p_h, p_v):
    kh, kv = jax.random.split(key)
    return {"h": _t(jax.random.bernoulli(kh, p_h, (b, 1, 1, 1))).reshape(b),
            "v": _t(jax.random.bernoulli(kv, p_v, (b, 1, 1, 1))).reshape(b)}


def j_blur_draws(key, b, p, sigma_limit):
    ks, kp = jax.random.split(key)
    return {"sigma": _t(jax.random.uniform(ks, (b,), minval=sigma_limit[0],
                                           maxval=sigma_limit[1])),
            "apply": _t(jax.random.bernoulli(kp, p, (b,)))}


def j_noise_draws(key, shapes, p, var_limit=(10.0, 50.0)):
    out = []
    for i, shape in enumerate(shapes):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, i), 3)
        b = shape[0]
        out.append({"apply": _t(jax.random.bernoulli(k1, p, (b, 1, 1, 1))).reshape(b),
                    "var": _t(jax.random.uniform(k2, (b, 1, 1, 1), minval=var_limit[0],
                                                 maxval=var_limit[1])).reshape(b),
                    "noise": _t(jax.random.normal(k3, shape))})
    return out


def j_mult_draws(key, n, b, p, limits=(0.9, 1.1)):
    out = []
    for i in range(n):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        out.append({"apply": _t(jax.random.bernoulli(k1, p, (b, 1, 1, 1))).reshape(b),
                    "mult": _t(jax.random.uniform(k2, (b, 1, 1, 1), minval=limits[0],
                                                  maxval=limits[1])).reshape(b)})
    return out


def j_elastic_draws(key, b, h, w, p, alpha_affine=50.0, same_dxdy=False):
    k_apply, k_aff, k_dx, k_dy = jax.random.split(key, 4)
    d = {"apply": _t(jax.random.bernoulli(k_apply, p, (b,))),
         "offsets": _t(jax.random.uniform(k_aff, (b, 3, 2), minval=-alpha_affine,
                                          maxval=alpha_affine)),
         "dx": _t(jax.random.uniform(k_dx, (b, h, w), minval=-1.0, maxval=1.0))}
    d["dy"] = d["dx"] if same_dxdy else _t(jax.random.uniform(k_dy, (b, h, w), minval=-1.0,
                                                               maxval=1.0))
    return d


def j_cutout_draws(key, b, h, w, p, num_holes=8, size=8):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"apply": _t(jax.random.bernoulli(k1, p, (b,))),
            "ys": _t(jax.random.randint(k2, (b, num_holes), 0, h - size)),
            "xs": _t(jax.random.randint(k3, (b, num_holes), 0, w - size))}


def j_pipeline_draws(key, batch, config):
    """The draws of JAX's augment_batch: its eight key splits, one an
    operation, in its order."""
    aug = config["augmentations"]
    keys = jax.random.split(key, 8)
    b, h, w = batch["post"].shape[:3]
    n = sum(k in batch for k in ta.IMAGE_KEYS)
    channels = [batch[k].shape[-1] for k in ta.IMAGE_KEYS if k in batch]
    d = {}
    if aug.get("RandomResizedCrop", {}).get("p", 0) > 0:
        rrc = aug["RandomResizedCrop"]
        d["RandomResizedCrop"] = j_crop_draws(keys[0], b, h, w, tuple(rrc["scale"]), rrc["p"])
        h = w = int(rrc["value"])
    if aug.get("GaussianBlur", {}).get("p", 0) > 0:
        gb = aug["GaussianBlur"]
        d["GaussianBlur"] = j_blur_draws(keys[1], b, gb["p"], tuple(gb["sigma_limit"]))
    p_h, p_v = aug.get("HorizontalFlip", {}).get("p", 0), aug.get("VerticalFlip", {}).get("p", 0)
    if p_h > 0 or p_v > 0:
        d["flips"] = j_flip_draws(keys[2], b, p_h, p_v)
    if aug.get("ElasticTransform", {}).get("p", 0) > 0:
        et = aug["ElasticTransform"]
        d["ElasticTransform"] = j_elastic_draws(keys[6], b, h, w, et["p"],
                                                float(et["alpha_affine"]))
    if aug.get("GaussNoise", {}).get("p", 0) > 0:
        d["GaussNoise"] = j_noise_draws(keys[3], [(b, h, w, c) for c in channels],
                                        aug["GaussNoise"]["p"])
    if aug.get("MultNoise", {}).get("p", 0) > 0:
        d["MultNoise"] = j_mult_draws(keys[4], n, b, aug["MultNoise"]["p"])
    if aug.get("Cutout", {}).get("p", 0) > 0:
        d["Cutout"] = j_cutout_draws(keys[5], b, h, w, aug["Cutout"]["p"])
    return d


# -- helpers ---------------------------------------------------------------------

def _images_masks(batch):
    images = [batch[k] for k in ("post", "pre1", "pre2")]
    masks = [batch[k] for k in ("mask", "valid")]
    return images, masks


def _torch(xs):
    return [torch.from_numpy(x) for x in xs]


def _jax(xs):
    return [jnp.asarray(x) for x in xs]


def _assert_list(got, want, exact, rtol=0.0, atol=5e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# -- each operation ----------------------------------------------------------------

@pytest.mark.parametrize("p,out_size", [(1.0, 40), (0.5, 40), (1.0, 24)],
                         ids=["p1", "p0.5", "resize-to-24"])
def test_random_resized_crop_matches_jax(p, out_size):
    batch = _batch()
    images, masks = _images_masks(batch)
    key = jax.random.PRNGKey(1)
    ji, jm = ja.random_resized_crop(key, _jax(images), _jax(masks), out_size, (0.2, 1.0), p=p)
    draws = j_crop_draws(key, 3, 40, 40, (0.2, 1.0), p)
    ti, tm = ta.random_resized_crop(_torch(images), _torch(masks), out_size, draws)
    _assert_list(ti, ji, exact=False)
    _assert_list(tm, jm, exact=True)


def test_flips_match_jax():
    batch = _batch(b=6)
    images, masks = _images_masks(batch)
    key = jax.random.PRNGKey(2)
    ji, jm = ja.flips(key, _jax(images), _jax(masks), 0.5, 0.5)
    ti, tm = ta.flips(_torch(images), _torch(masks), j_flip_draws(key, 6, 0.5, 0.5))
    _assert_list(ti, ji, exact=True)
    _assert_list(tm, jm, exact=True)


def test_gaussian_blur_matches_jax():
    images, _ = _images_masks(_batch(b=4))
    key = jax.random.PRNGKey(3)
    want = ja.gaussian_blur(key, _jax(images), 0.7, (0.1, 2.0))
    got = ta.gaussian_blur(_torch(images), j_blur_draws(key, 4, 0.7, (0.1, 2.0)), (0.1, 2.0))
    _assert_list(got, want, exact=False)


def test_noise_matches_jax():
    images, _ = _images_masks(_batch(b=4))
    key = jax.random.PRNGKey(4)
    want = ja.gauss_noise(key, _jax(images), 0.6)
    got = ta.gauss_noise(_torch(images), j_noise_draws(key, [x.shape for x in images], 0.6))
    _assert_list(got, want, exact=False, rtol=1e-6, atol=0.0)
    want = ja.multiplicative_noise(key, _jax(images), 0.6)
    got = ta.multiplicative_noise(_torch(images), j_mult_draws(key, 3, 4, 0.6))
    _assert_list(got, want, exact=True)


def test_cutout_matches_jax():
    images, masks = _images_masks(_batch(b=4))
    key = jax.random.PRNGKey(5)
    ji, jm = ja.cutout(key, _jax(images), _jax(masks), 0.6)
    ti, tm = ta.cutout(_torch(images), _torch(masks), j_cutout_draws(key, 4, 40, 40, 0.6))
    _assert_list(ti, ji, exact=True)
    _assert_list(tm, jm, exact=True)


def _assert_elastic(got, want):
    (ti, tm), (ji, jm) = got, want
    _assert_list(ti, ji, exact=False, atol=1e-4)
    for g, w in zip(tm, jm):
        assert np.mean(g.numpy() != np.asarray(w)) <= 2e-3


@pytest.mark.parametrize("same_dxdy,approximate", [(False, True), (True, False)],
                         ids=["approximate", "exact-same-dxdy"])
def test_elastic_transform_matches_jax(same_dxdy, approximate):
    images, masks = _images_masks(_batch(b=3))
    key = jax.random.PRNGKey(6)
    want = ja.elastic_transform(key, _jax(images), _jax(masks), 0.7, alpha=3.0, sigma=4.0,
                                alpha_affine=5.0, same_dxdy=same_dxdy, approximate=approximate)
    draws = j_elastic_draws(key, 3, 40, 40, 0.7, 5.0, same_dxdy)
    got = ta.elastic_transform(_torch(images), _torch(masks), draws, alpha=3.0, sigma=4.0,
                               approximate=approximate)
    _assert_elastic(got, want)


# -- the pipeline ---------------------------------------------------------------------

def _pipeline(batch, aug, key):
    cfg = {"augmentations": aug}
    want = ja.augment_batch(key, {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    got = ta.apply_augmentations({k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                                 j_pipeline_draws(key, batch, cfg))
    return got, want


def test_augment_batch_on_the_shipped_config_matches_jax():
    """The shipped configs/augmentations/augmentation.json (RandomResizedCrop
    p=1 to 224, HorizontalFlip p=0.5) on a 224^2 batch with a DEM."""
    batch = _batch(b=2, size=224, seed=7)
    batch["dem"] = np.random.RandomState(8).randn(2, 224, 224, 1).astype(np.float32)
    got, want = _pipeline(batch, SHIPPED, jax.random.PRNGKey(7))
    for k in ("post", "pre1", "pre2", "dem"):
        _assert_list([got[k]], [want[k]], exact=False)
    for k in ("mask", "valid"):
        _assert_list([got[k]], [want[k]], exact=True)


def test_augment_batch_with_every_operation_matches_jax():
    batch = _batch(b=3, seed=9)
    got, want = _pipeline(batch, EVERY, jax.random.PRNGKey(9))
    _assert_elastic(([got[k] for k in ("post", "pre1", "pre2")],
                     [got[k] for k in ("mask", "valid")]),
                    ([want[k] for k in ("post", "pre1", "pre2")],
                     [want[k] for k in ("mask", "valid")]))


def test_discard_if_empty_keeps_the_originals_as_jax():
    """A sample whose valid pixels sit in one corner: under a crop that
    misses them it keeps its original images and masks, in both packages."""
    batch = _batch(b=2, seed=10)
    batch["valid"][0] = 0
    batch["valid"][0, :3, :3] = 1
    aug = {"RandomResizedCrop": {"value": 40, "scale": [0.2, 0.3], "p": 1.0}}
    for seed in range(20):
        got, want = _pipeline(batch, aug, jax.random.PRNGKey(seed))
        if np.array_equal(np.asarray(want["post"][0]), batch["post"][0]):
            break
    else:
        pytest.fail("no crop of 20 missed the corner")
    draws = j_pipeline_draws(jax.random.PRNGKey(seed), batch, {"augmentations": aug})
    crop = ta.random_resized_crop([torch.from_numpy(batch["post"])],
                                  [torch.from_numpy(batch["valid"])], 40,
                                  draws["RandomResizedCrop"])
    assert crop[1][0][0].sum() == 0 and crop[1][0][1].sum() > 0  # the rule's case
    for k in ("post", "pre1", "pre2"):
        _assert_list([got[k]], [want[k]], exact=False)
        np.testing.assert_array_equal(got[k][0].numpy(), batch[k][0])
    for k in ("mask", "valid"):
        _assert_list([got[k]], [want[k]], exact=True)


def test_unsupported_operation_raises_as_jax():
    batch = {k: torch.from_numpy(v) for k, v in _batch(b=1).items()}
    cfg = {"augmentations": dict(SHIPPED, ColorJitter={"brightness": 0.2, "p": 0.2})}
    with pytest.raises(ValueError, match="ColorJitter"):
        ta.augment_batch(torch.Generator().manual_seed(0), batch, cfg)
    with pytest.raises(ValueError, match="ColorJitter"):
        ja.augment_batch(jax.random.PRNGKey(0), {k: jnp.asarray(v.numpy())
                                                 for k, v in batch.items()}, cfg)
    # at p = 0 (as shipped) it is accepted
    ta.augment_batch(torch.Generator().manual_seed(0), batch, {"augmentations": SHIPPED})


def test_the_ports_draws_have_the_jax_draws_form():
    """Same operations, keys, shapes and dtypes as the draws recovered from
    JAX, within the same ranges; the same generator seed draws the same."""
    batch = _batch(b=5, seed=11)
    cfg = {"augmentations": EVERY}
    got = ta.draw_augmentations(torch.Generator().manual_seed(0),
                                {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    want = j_pipeline_draws(jax.random.PRNGKey(0), batch, cfg)
    assert list(got) == list(want)

    def flat(d, prefix=""):
        if isinstance(d, dict):
            return {k2: v2 for k, v in d.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
        if isinstance(d, list):
            return {k2: v2 for i, v in enumerate(d) for k2, v2 in flat(v, f"{prefix}{i}.").items()}
        return {prefix: d}

    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype.is_floating_point == \
            w[k].dtype.is_floating_point, k
    box = got["RandomResizedCrop"]
    assert ((box["ch"] >= 8) & (box["ch"] <= 40) & (box["y0"] >= 0)
            & (box["y0"] + box["ch"] <= 40 + 1e-4)).all()
    assert (got["Cutout"]["ys"] < 32).all() and got["GaussianBlur"]["sigma"].max() <= 2.0
    again = ta.draw_augmentations(torch.Generator().manual_seed(0),
                                  {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert all(torch.equal(a, b) for a, b in zip(flat(again).values(), g.values()))
