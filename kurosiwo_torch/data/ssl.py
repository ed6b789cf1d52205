"""SSL (unlabeled) corpus loader for MAE pretraining; the port's own copy of
``kurosiwo_tpu/data/ssl.py``. A batch is bitwise the JAX ``SSLLoader``'s for
the same config and seed.

Parity with SSLDataset (the reference's ``dataset/Dataset.py:864-983``):
  * recursive walk of every grid dir under root/data, cached to
    ``ssl_samples.pkl`` in the working directory; deterministic shuffle with
    ``random.Random(999)``;
  * per sample: 3 events x 2 pols -> clamp/nan -> the hard-coded corpus
    statistics (mean [0.0953, 0.0264], std [0.0427, 0.0215]) -> channel
    order (flood, pre1, pre2) -> a 6-channel stack;
  * RandomResizedCrop(scale 0.2-1.0) + HFlip(0.5) on the host with numpy
    and cv2's bicubic resize, from ``default_rng(seed + 31 i + epoch_tag)``
    per sample, ``epoch_tag`` advancing at each epoch's start; no shuffle
    (the sample list is shuffled once).

Without ``root_path/data`` (or with ``synthetic_data``) the samples are
gamma draws of ``RandomState((seed * 7,654,321 + i) mod (2^31 - 1))``.

The rows are decoded by the Loader's decode processes into its ring of
batch buffers in shared memory (``pipeline.BatchRing``), which the engine's
``device_prefetch`` uploads from; the JAX loader decodes on threads. Under
data parallelism each process decodes its row block of every global batch
(``pipeline.resolve_process_grid``), as the JAX loader does.
"""

from __future__ import annotations

import os
import pickle
import random
from pathlib import Path

import numpy as np

from .pipeline import Loader, resolve_process_grid
from .tiles import _imread, list_tile_files, stack_channels

SSL_MEAN = np.array([0.0953, 0.0264], np.float32)
SSL_STD = np.array([0.0427, 0.0215], np.float32)


def walk_ssl_samples(root_path: str, cache: str = "ssl_samples.pkl") -> list[str]:
    """Every sample directory under ``root_path/data`` (read from ``cache``
    when it exists, else walked and written there), shuffled by
    ``random.Random(999)``. A subfolder holding files directly is listed
    once for each file, as the reference lists it."""
    if os.path.isfile(cache):
        with open(cache, "rb") as f:
            samples = pickle.load(f)
    else:
        samples = []
        data_root = Path(root_path) / "data"
        for event in sorted(os.listdir(data_root)):
            folder_dir = data_root / event
            if not folder_dir.is_dir():
                continue
            for folder in sorted(os.listdir(folder_dir)):
                if ".gpkg" in folder:
                    continue
                subfolder_dir = folder_dir / folder
                if not subfolder_dir.is_dir():
                    continue
                for subfolder in sorted(os.listdir(subfolder_dir)):
                    hashes_dir = subfolder_dir / subfolder
                    if not hashes_dir.is_dir():
                        samples.append(str(subfolder_dir))
                        continue
                    for hash_folder in sorted(os.listdir(hashes_dir)):
                        p = hashes_dir / hash_folder
                        samples.append(str(subfolder_dir / subfolder) if p.is_file() else str(p))
        with open(cache, "wb") as f:
            pickle.dump(samples, f)
    random.Random(999).shuffle(samples)
    return samples


def random_resized_crop_flip(img: np.ndarray, rng: np.random.Generator, size: int = 224,
                             scale=(0.2, 1.0)) -> np.ndarray:
    """HWC random-resized crop (area-scale sampling, 10 tries, else the whole
    image), bicubic resize to ``size``, horizontal flip with p 0.5."""
    import cv2

    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * ar)))
        ch = int(round(np.sqrt(target_area / ar)))
        if cw <= w and ch <= h:
            y0 = rng.integers(0, h - ch + 1)
            x0 = rng.integers(0, w - cw + 1)
            crop = img[y0: y0 + ch, x0: x0 + cw]
            break
    else:
        crop = img
    out = cv2.resize(crop, (size, size), interpolation=cv2.INTER_CUBIC)
    if out.ndim == 2:
        out = out[..., None]
    if rng.uniform() < 0.5:
        out = out[:, ::-1]
    return np.ascontiguousarray(out)


class SSLDecoder:
    """A sample's index and epoch tag -> its augmented (size, size, 6) f32
    image. Picklable, so each decode process holds a copy."""

    def __init__(self, config: dict, samples: list[str], seed: int, synthetic: bool):
        self.config = config
        self.samples = samples
        self.seed = seed
        self.synthetic = synthetic
        self.size = int(config.get("image_size", 224))

    def read_stack(self, index: int) -> np.ndarray:
        cfg = self.config
        clamp = cfg.get("clamp_input", 0.15)
        if self.synthetic:
            size = int(cfg.get("synthetic_patch_size", 224))
            rng = np.random.RandomState((self.seed * 7_654_321 + index) % (2**31 - 1))
            parts = [np.clip(rng.gamma(2.0, (clamp or 0.15) / 6.0, (size, size, 2)), 0, clamp)
                     .astype(np.float32) for _ in range(3)]
        else:
            files = list_tile_files(self.samples[index])
            parts = [stack_channels(_imread(files[kv]), _imread(files[kh]), cfg["channels"], clamp)
                     for kv, kh in (("post_vv", "post_vh"), ("pre1_vv", "pre1_vh"),
                                    ("pre2_vv", "pre2_vh"))]
        nch = parts[0].shape[-1]
        if nch != len(SSL_MEAN):
            # the statistics are (vv, vh): other channels would be normalised
            # with the wrong ones
            raise ValueError(
                f"SSL corpus stats are per-channel for {len(SSL_MEAN)} channels "
                f"(vv, vh); got {nch} channels from {cfg.get('channels')}")
        parts = [(p - SSL_MEAN) / SSL_STD for p in parts]
        return np.concatenate(parts, axis=-1).astype(np.float32)  # (H, W, 6)

    def process(self, job: tuple) -> dict:
        index, epoch_tag = job
        rng = np.random.default_rng(self.seed + 31 * int(index) + epoch_tag)
        return {"image": random_resized_crop_flip(self.read_stack(int(index)), rng,
                                                  size=self.size)}

    def fill(self, arrays: dict, row: int, job: tuple) -> None:
        image = self.process(job)["image"]
        dst = arrays["image"]
        if image.shape != dst.shape[1:] or image.dtype != dst.dtype:
            raise ValueError(f"SSL sample {job[0]} is {image.dtype}{image.shape}, the batch's "
                             f"{dst.dtype}{dst.shape[1:]}")
        dst[row] = image


class SSLLoader(Loader):
    """Batches ``{"image": (B, size, size, 6) f32}`` of augmented SSL samples
    for MAE, in the sample list's order, the last partial batch dropped;
    each iteration is an epoch. A ``Loader`` (ring, decode processes,
    ``ring_batches``, ``close``) with the SSL decoder."""

    def __init__(self, config: dict, seed: int = 999, synthetic: bool | None = None,
                 process_index: int | None = None, process_count: int | None = None):
        self.mode = "ssl"
        self.config = config
        self.batch_size = int(config["batch_size"])
        self.process_index, self.process_count, self.local_batch_size = resolve_process_grid(
            self.batch_size, process_index, process_count)
        self.seed = seed
        self.workers = int(config.get("num_workers", 8)) or 1
        root = Path(config.get("root_path", "."))
        if synthetic is None:
            synthetic = bool(config.get("synthetic_data")) or not (root / "data").exists()
        self.synthetic = synthetic
        if synthetic:
            self.samples = [f"synthetic_{i}" for i in range(int(config.get("synthetic_size", 256)))]
        else:
            self.samples = walk_ssl_samples(str(root))
        n_per_epoch = config.get("num_samples_per_epoch")
        if n_per_epoch:
            self.samples = self.samples[: int(n_per_epoch)]
        self.decoder = SSLDecoder(config, self.samples, seed, synthetic)
        self._epoch_tag = 0
        self._ring = self._workers = self._finalizer = self._feeder = None

    def __len__(self):
        return len(self.samples) // self.batch_size

    def num_samples(self):
        return len(self.samples)

    def _first_sample(self) -> dict:
        return self.decoder.process((0, 0))

    def _epoch_batches(self) -> list:
        self._epoch_tag += 1
        bs, tag = self.batch_size, self._epoch_tag
        return [[(i, tag) for i in range(lo, lo + bs)]
                for lo in range(0, len(self.samples) - bs + 1, bs)]
