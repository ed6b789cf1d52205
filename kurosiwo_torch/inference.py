"""Inference and serving on one card: a trained model over the tiles of a
scene, or a ViT encoder over a whole scene at once; counterpart of the
single-device part of ``kurosiwo_tpu/inference.py``.

  * ``TilePredictor``: the segmentation model's eval forward over batches of
    fixed-size tiles, the ragged last batch padded by repeating its last tile
    (the batch shape stays fixed); logits come back to the host in f32;
  * ``predict_scene``: sliding-window class map of an (H, W, C) scene of any
    size, overlapping logits averaged on the host;
  * ``vit_whole_scene`` / ``encode_scene``: the whole scene's patch grid as
    ONE attention sequence (4,096 tokens for a 1024x1024 scene at patch 16),
    which the router sends to the flash attention kernel (B5) when the
    sequence is 1,024 tokens or more with a 128-multiple block;
  * ``load_variables``: the fresh-init route (``checkpoint=""``), the
    port's own checkpoints (``dir/best_segmentation``) and the reference's
    torch ``.pt`` files (converted by the method's converter);
  * ``main``: the raster command line, ``python -m kurosiwo_torch.inference
    --vv VV.tif --vh VH.tif --checkpoint dir/best_segmentation|model.pt
    [--method unet] [--device cuda|cpu]``.

  * ``vit_whole_scene_cp``: the same encode with the token sequence sharded
    over the ranks of a ``MeshPlan``'s model axis, ring attention in every
    layer (context parallelism).

Not ported: the JAX package's orbax checkpoint route (its own format, read
with orbax and JAX).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .device import resolve_device
from .models.vit import ViT, patchify
from .ops.ring_attention import SOLO
from .parallel.mesh import MeshPlan, full_param
from .parallel.sharding import is_sharded


class TilePredictor:
    """Batched eval forward of a segmentation model for fixed-size NHWC
    tiles, on ``device`` (the card unless the caller asks for the CPU); the
    model is moved there and put in eval mode. It runs in its own compute
    dtype (bf16 for the bench config)."""

    def __init__(self, model, tile: int = 224, batch_size: int = 32,
                 device: str | torch.device | None = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tile = tile
        self.batch_size = batch_size

    def predict_logits(self, tiles: np.ndarray) -> np.ndarray:
        """(N, T, T, C) -> (N, T, T, num_classes) float32 logits."""
        outs = []
        bs = self.batch_size
        with torch.inference_mode():
            for i in range(0, tiles.shape[0], bs):
                chunk = tiles[i: i + bs]
                pad = bs - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(self.device)
                logits = self.model(x).cpu().float().numpy()  # bf16 -> f32 on the host
                outs.append(logits[: bs - pad] if pad else logits)
        return np.concatenate(outs, axis=0)

    def predict(self, tiles: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_logits(tiles), axis=-1).astype(np.uint8)


def predict_scene(predictor: TilePredictor, scene: np.ndarray, overlap: int = 32) -> np.ndarray:
    """Sliding-window class map for an (H, W, C) scene of any size: the
    argmax of :func:`blend_scene`."""
    return np.argmax(blend_scene(predictor, scene, overlap), axis=-1).astype(np.uint8)


def blend_scene(predictor, scene: np.ndarray, overlap: int = 32) -> np.ndarray:
    """(H, W, classes) f32 logits of an (H, W, C) scene: windows of
    ``predictor.tile`` with ``overlap`` stride reduction, overlapping logits
    averaged (soft blending suppresses window-border artifacts). Any
    ``predictor`` with ``tile`` and ``predict_logits`` will do."""
    t = predictor.tile
    h, w, _ = scene.shape
    if not 0 <= overlap < t:
        raise ValueError(
            f"overlap must be in [0, tile={t}), got {overlap} — overlap==tile "
            "gives a zero stride and larger values would leave the scene "
            "mostly unpredicted")
    stride = t - overlap
    ny = max(1, math.ceil(max(h - overlap, 1) / stride))
    nx = max(1, math.ceil(max(w - overlap, 1) / stride))
    pad_h = (ny - 1) * stride + t - h
    pad_w = (nx - 1) * stride + t - w
    # symmetric (not reflect): reflect caps the pad width at dim - 1, which a
    # scene smaller than the tile exceeds; symmetric allows pad == dim, and
    # repeated passes cover any remainder
    padded = scene
    while pad_h > 0 or pad_w > 0:
        ph = min(max(pad_h, 0), padded.shape[0])
        pw = min(max(pad_w, 0), padded.shape[1])
        padded = np.pad(padded, ((0, ph), (0, pw), (0, 0)), mode="symmetric")
        pad_h -= ph
        pad_w -= pw

    tiles, coords = [], []
    for iy in range(ny):
        for ix in range(nx):
            y0, x0 = iy * stride, ix * stride
            tiles.append(padded[y0: y0 + t, x0: x0 + t])
            coords.append((y0, x0))
    logits = predictor.predict_logits(np.stack(tiles))

    acc = np.zeros(padded.shape[:2] + (logits.shape[-1],), np.float32)
    cnt = np.zeros(padded.shape[:2] + (1,), np.float32)
    for (y0, x0), lg in zip(coords, logits):
        acc[y0: y0 + t, x0: x0 + t] += lg
        cnt[y0: y0 + t, x0: x0 + t] += 1.0
    return (acc / np.maximum(cnt, 1.0))[:h, :w]


def interpolate_pos_embedding(pos: torch.Tensor, new_grid: tuple[int, int]) -> torch.Tensor:
    """Resample a (1, 1 + g*g, D) learned position embedding to a new patch
    grid (cls slot dropped), (1, gh*gw, D). ``jax.image.resize(...,
    "linear")`` antialiases when it downsamples (a grid under g x g, i.e. a
    scene under 224 px at patch 16), so this is bilinear with
    ``antialias=True``; upsampling is plain bilinear either way."""
    grid = pos[:, 1:]
    g = math.isqrt(grid.shape[1])
    d = grid.shape[-1]
    img = grid.reshape(1, g, g, d).permute(0, 3, 1, 2)
    img = F.interpolate(img, size=tuple(new_grid), mode="bilinear", align_corners=False,
                        antialias=True)
    return img.permute(0, 2, 3, 1).reshape(1, new_grid[0] * new_grid[1], d)


def _layer_norm_f32(norm, t: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm with the JAX inference code's formula (variance of the
    centred values, eps 1e-6) and the module's scale and bias."""
    mu = t.mean(-1, keepdim=True)
    var = (t - mu).square().mean(-1, keepdim=True)
    return (t - mu) / torch.sqrt(var + 1e-6) * norm.scale + norm.bias


def _embed_scene_tokens(vit: ViT, x: torch.Tensor, dtype: torch.dtype,
                        rows: slice = slice(None)) -> torch.Tensor:
    """Patch embed (LN -> Linear -> LN, all in f32) + resampled positions, no
    cls token (JAX ``_embed_scene_tokens``); deliberately not
    ``ViT.embed_image``, which folds the first LayerNorm into a convolution
    in the compute dtype. Tokens are cast to ``dtype`` after the second
    LayerNorm; the positions are cast to it and added in it. ``rows``: the
    tokens to embed (a shard of the sequence), default all."""
    p = vit.patch_size
    gh, gw = x.shape[1] // p, x.shape[2] // p
    patches = patchify(x, p)[:, rows].float()
    tokens = _layer_norm_f32(vit.patch_norm1, patches)
    tokens = vit.patch_proj(tokens, torch.float32)
    tokens = _layer_norm_f32(vit.patch_norm2, tokens).to(dtype)
    pos = full_param(vit, "pos_embedding")
    return tokens + interpolate_pos_embedding(pos, (gh, gw))[:, rows].to(dtype)


def encode_scene(vit: ViT, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The encoder over a device-resident (1, H, W, C) scene whose sides are
    multiples of the patch size: (1, gh*gw, dim) patch features in
    ``dtype``. The scene is rounded to ``dtype`` first, as the JAX package
    uploads it."""
    with torch.inference_mode():
        tokens = _embed_scene_tokens(vit, x.to(dtype), dtype)
        return vit.transformer(tokens, dtype)


def pad_scene(scene: np.ndarray, patch_size: int) -> np.ndarray:
    """Reflect-pad an (H, W, C) scene up to whole patches."""
    h, w, _ = scene.shape
    ph = -(-h // patch_size) * patch_size
    pw = -(-w // patch_size) * patch_size
    return np.pad(scene, ((0, ph - h), (0, pw - w), (0, 0)), mode="reflect")


def vit_whole_scene(encoder: ViT, scene: np.ndarray, dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Encode an ENTIRE (H, W, C) scene as one attention sequence (no 224
    tiling): the scene is reflect-padded to whole patches, uploaded and run
    through ``encoder`` (the port's ``ViT``, moved to ``device``: the card
    unless the caller asks for the CPU). The learned positions are resampled
    to the scene's grid and the cls token is dropped, so a 1024x1024 scene is
    4,096 tokens, which take the flash attention kernel.

    Returns (1, gh*gw, dim) patch features in ``dtype`` on ``device``;
    reshape to (gh, gw, dim) for a dense head."""
    dev = resolve_device(device)
    encoder = encoder.to(dev)
    # rounded to ``dtype`` on the host, as the JAX package uploads it: half
    # the bytes over the bus for bf16
    x = torch.from_numpy(np.ascontiguousarray(pad_scene(scene, encoder.patch_size)[None],
                                              np.float32)).to(dtype).to(dev)
    return encode_scene(encoder, x, dtype)


def vit_whole_scene_cp(encoder: ViT, scene: np.ndarray, plan: MeshPlan,
                       dtype: torch.dtype = torch.bfloat16,
                       device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Context-parallel ``vit_whole_scene`` (JAX ``inference.py:205-290``):
    the scene's patch-token sequence is sharded over ``plan``'s model axis,
    each rank embeds its contiguous shard of tokens and encodes it with ring
    attention in every layer (``ops/ring_attention``), so no rank holds more
    than N/P tokens of k/v. Everything outside attention is token-pointwise.
    A plan without a process group is a ring of this process alone.

    The scene is reflect-padded to whole patches; the token count gh*gw must
    divide by the ring size, else ValueError (grow the scene by patch rows).
    Every rank returns the gathered (1, gh*gw, dim) features in ``dtype`` on
    ``device`` (the card unless the caller asks for the CPU), as the JAX
    function returns the whole array. A tensor-parallel encoder
    (``parallel/sharding.apply_shardings``) is refused: both use the model
    axis, as in JAX."""
    if is_sharded(encoder):
        raise ValueError("vit_whole_scene_cp takes a whole encoder: tensor parallelism and the "
                         "ring share the model axis (this one's parameters are cut over it)")
    dev = resolve_device(device)
    encoder = encoder.to(dev)
    padded = pad_scene(scene, encoder.patch_size)
    gh, gw = padded.shape[0] // encoder.patch_size, padded.shape[1] // encoder.patch_size
    n, p = gh * gw, plan.num_model
    if n % p:
        raise ValueError(f"token grid {gh}x{gw}={n} does not divide by the ring size {p}; pad "
                         "the scene so the patch grid is a multiple of the ring size")
    group = plan.model_group if plan.model_group is not None else SOLO
    shard = n // p
    rows = slice(plan.model_index * shard, (plan.model_index + 1) * shard)
    x = torch.from_numpy(np.ascontiguousarray(padded[None], np.float32)).to(dtype).to(dev)
    with torch.inference_mode():
        tokens = _embed_scene_tokens(encoder, x, dtype, rows)
        out = encoder.transformer(tokens, dtype, ring_axis=group)
        if p == 1:
            return out
        parts = [torch.empty_like(out) for _ in range(p)]
        dist.all_gather(parts, out.contiguous(), group=group)
        return torch.cat(parts, dim=1)


def load_variables(checkpoint: str, model: torch.nn.Module,
                   method: str = "snunet") -> dict[str, torch.Tensor]:
    """The model's ``state_dict`` (parameters and BatchNorm buffers, on the
    CPU) for ``checkpoint``: its own seeded initialisation for ``""``
    (smoke runs); for a torch ``.pt`` / ``.pth`` file, the reference's
    checkpoint converted by ``method``'s converter (``convert.convert``, as
    the JAX package's ``convert(path, config.get("method", "snunet"))``),
    with the model's BatchNorm statistics where the file has none; for
    ``dir/name``, the port's checkpoint ``name`` under ``dir``
    (``training/checkpoint.py``: ``dir/name.ptr.json`` naming a committed
    slot, as ``best_segmentation`` is), the form the JAX package's
    ``load_variables`` takes. A missing path raises ``FileNotFoundError``
    (a typo must not produce a confident garbage mask). Orbax directories,
    the JAX package's own format, are refused: reading one needs orbax and
    JAX, which the port does not import."""
    if not checkpoint:
        return model.state_dict()
    p = Path(checkpoint)
    if p.suffix in (".pt", ".pth"):
        from .convert import convert, with_statistics

        return with_statistics(convert(p, method), model.state_dict())
    if (p.parent / f"{p.name}.ptr.json").is_file():
        from .training.checkpoint import CheckpointManager

        payload, _ = CheckpointManager(p.parent).load(p.name, map_location="cpu")
        return payload["model"]
    if not p.exists():
        raise FileNotFoundError(f"checkpoint {checkpoint!r} does not exist")
    raise NotImplementedError(
        f"{checkpoint!r} is neither a torch .pt/.pth file nor the port's own dir/name checkpoint "
        "(dir/best_segmentation): orbax directories are the JAX package's format, and reading "
        "one needs orbax and JAX, which the port does not import (ROADMAP.md, Not to port)")


def main(argv=None) -> np.ndarray:
    """The raster command line (JAX ``inference.main``): the model of
    ``--method`` (``load_config`` with ``inputs`` ["post_event"], so two
    channels) with ``load_variables(--checkpoint, --method)``, over the VV and VH
    rasters stacked, clamped and normalized as the loader does, by
    ``predict_scene``; writes the class map to ``<out>.mask.png`` and the
    overlay (``utils/visualize``) to ``--out`` with cv2, and prints the
    scene's size and class pixel counts. Runs on the card unless
    ``--device cpu``. Returns the class map."""
    import argparse

    import cv2

    from .config import load_config
    from .data.normalize import normalize
    from .data.tiles import _imread, stack_channels
    from .device import configure_backends
    from .models.factory import initialize_segmentation_model
    from .utils.visualize import overlay_mask, sar_to_rgb

    ap = argparse.ArgumentParser(prog="python -m kurosiwo_torch.inference",
                                 description="Scene inference (flood mapping)")
    ap.add_argument("--vv", required=True, help="VV backscatter raster (tif)")
    ap.add_argument("--vh", required=True, help="VH backscatter raster (tif)")
    ap.add_argument("--checkpoint", default="",
                    help="the port's checkpoint as dir/name (dir/best_segmentation), or a "
                         "reference torch .pt (converted by --method); empty: the seeded "
                         "initialisation")
    ap.add_argument("--method", default="unet")
    ap.add_argument("--out", default="flood_mask.png")
    ap.add_argument("--overlap", type=int, default=32)
    ap.add_argument("--config_root", default="configs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = load_config(method=args.method, config_root=args.config_root,
                      overrides={"inputs": ["post_event"]})
    configure_backends(cfg, args.device)  # before CUDA's first use (cuBLAS's workspace)
    scene = stack_channels(_imread(args.vv), _imread(args.vh), cfg["channels"],
                           cfg.get("clamp_input"))
    scene = normalize(scene, cfg["data_mean"], cfg["data_std"])

    model = initialize_segmentation_model(cfg, cfg["model_config"], device=args.device)
    model.load_state_dict(load_variables(args.checkpoint, model, args.method))
    mask = predict_scene(TilePredictor(model, device=args.device), scene, overlap=args.overlap)

    cv2.imwrite(str(Path(args.out).with_suffix(".mask.png")), mask)
    cv2.imwrite(args.out, overlay_mask(sar_to_rgb(scene), mask)[..., ::-1])
    h, w = mask.shape
    counts = {int(k): int(v) for k, v in zip(*np.unique(mask, return_counts=True))}
    print(f"scene {h}x{w}; class pixel counts: {counts}; wrote {args.out}", flush=True)
    return mask


if __name__ == "__main__":
    main()
