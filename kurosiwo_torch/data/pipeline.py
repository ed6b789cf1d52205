"""Prefetching host loader -> fixed batch structs of numpy arrays; the port's
own copy of ``kurosiwo_tpu/data/pipeline.py``. A batch is bitwise the JAX
loader's for the same config and seed: the same records, the same seeded
draws, the same decode and padding.

A seeded sampler picks indices (50/50 positive/negative oversampling,
Dataset.py:641-651, from a dedicated ``np.random.Generator``). Decode worker
processes each write a processed sample straight into its row of a batch
buffer: there is no collate. The buffers are a small ring in shared memory
(``BatchRing``), as many as the prefetch depth plus the batch being filled;
for a consumer on the card they are page-locked in place, so the engine's
``device_prefetch`` uploads from them with no second host copy, and a buffer
is refilled only after its upload's event has completed.

Batch struct (numpy, NHWC):
  post, pre1, pre2 : (B, H, W, C) float32   — scaled acquisitions
  mask             : (B, H, W)    int32     — labels {0,1,2,3}
  valid            : (B, H, W)    int32
  dem              : (B, H, W, 1) float32   — only when config["dem"]
  clz, activation  : (B,) int32
  sample_weight    : (B,) float32           — 0 for eval padding samples
  *_sv1/_sv2       : (B, C) float32         — scale vars when scale_input set

Eval splits pad the final partial batch to full size (sample_weight 0, mask
all-ignore), so every eval batch has the step's shape.

The MAE task's SSL loader (``data/ssl.py``) runs on the same ring and
decode processes with a decoder of its own.

Decoding runs in processes, not threads: the decode is numpy work that holds
the interpreter lock often, and decode threads slowed the train step's own
host side, which shares that lock (PERF.md §6).

The process grid (``resolve_process_grid``), as the JAX loader's:
``batch_size`` is the GLOBAL batch, every process draws the same epoch
indices (``epoch_rng``) and decodes only its contiguous row block of each
batch into a ring of local-size buffers, with its own decode processes.
An eval batch pads each process's block: a process whose whole block is
padding gets zero samples of weight 0 and mask 3, and still steps. The SLC
loader (``data/slc.py``, ``slc: true``) runs on the same ring and decode
processes with a decoder of its own. A loader that decodes tiles from disk
prints the tile decoder it uses (``tiles.decoder_choice``) at its start.

The diffusion task (``diffusion-unsup``) reads per-observation records:
each patch's pre1, pre2 and flood acquisitions as three typed records
(``data/index.py`` types a corpus's; the synthetic source's are typed
here), each decoded to ``image`` (H, W, 2) f32 (scaled where
``scale_input`` is set) with ``clz``, ``activation`` and
``sample_weight``; such a batch has no ``mask``.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import multiprocessing.sharedctypes
import queue
import threading
import weakref
import zlib
from pathlib import Path
from typing import Callable, Iterator

import numpy as np

from .index import GridIndex, Record
from .normalize import compute_min_max_stats, scale_img
from .synthetic import synthetic_raw_sample, synthetic_records
from .tiles import RawSample, decoder_choice, read_raw_sample


def _needs_stats(config) -> bool:
    mode = config.get("scale_input")
    return mode in ("min-max", "custom") or isinstance(mode, (list, tuple))


def resolve_process_grid(batch_size: int, process_index: int | None = None,
                         process_count: int | None = None) -> tuple[int, int, int]:
    """(process_index, process_count, local batch size) of every loader: the
    given grid, else the process group's (``parallel/distributed``). Raises
    on a batch the count does not divide (its tail rows would silently never
    decode)."""
    if process_index is None or process_count is None:
        from ..parallel.distributed import process_info

        process_index, process_count = process_info()
    process_index, process_count = int(process_index), int(process_count)
    if batch_size % process_count:
        raise ValueError(f"batch_size {batch_size} not divisible by process count "
                         f"{process_count} (tail rows would silently never decode)")
    return process_index, process_count, batch_size // process_count


def epoch_rng(seed: int, mode: str) -> np.random.Generator:
    """Per-split epoch rng. zlib.crc32, NOT hash(): str hash is salted per
    process (PYTHONHASHSEED)."""
    return np.random.default_rng(seed + zlib.crc32(mode.encode()) % 65536)


class SampleDecoder:
    """A record -> its processed sample dict: the packed, tile or synthetic
    read, then the scaling. Picklable, so each decode process holds a copy."""

    def __init__(self, config: dict, records: list[Record], stats: dict | None, seed: int,
                 synthetic: bool, shard_reader=None):
        self.config = config
        self.records = records
        self.stats = stats
        self.seed = seed
        self.synthetic = synthetic
        self.shard_reader = shard_reader

    def read(self, record: Record) -> RawSample:
        if self.shard_reader is not None and record.id in self.shard_reader:
            return self.shard_reader.read(record.id)
        if self.synthetic:
            size = int(self.config.get("synthetic_patch_size", 224))
            return synthetic_raw_sample(record, self.config, size=size, seed=self.seed)
        return read_raw_sample(str(self.config.get("root_path", ".")), record, self.config)

    def process(self, record: Record) -> dict:
        raw = self.read(record)
        cfg = self.config
        if record.type is not None:
            # diffusion-unsup: one record per observation (Dataset.py:118-130)
            img = {"pre1": raw.pre1, "pre2": raw.pre2, "flood": raw.post}[record.type]
            if cfg.get("scale_input") is not None:
                _, _, img = scale_img(img, raw.valid == 1, record.type, raw.activation, cfg,
                                      self.stats)
            return {"image": img.astype(np.float32), "clz": np.int32(raw.clz),
                    "activation": np.int32(raw.activation), "sample_weight": np.float32(1.0)}
        out: dict = {}
        if cfg.get("scale_input") is not None:
            valid_bool = raw.valid == 1
            sv = {}
            for name, img in (("flood", raw.post), ("pre1", raw.pre1), ("pre2", raw.pre2)):
                v1, v2, scaled = scale_img(img, valid_bool, name, raw.activation, cfg, self.stats)
                sv[name] = (np.asarray(v1, np.float32), np.asarray(v2, np.float32))
                out[{"flood": "post", "pre1": "pre1", "pre2": "pre2"}[name]] = scaled.astype(np.float32)
            for name in ("flood", "pre1", "pre2"):
                out[f"{name}_sv1"], out[f"{name}_sv2"] = sv[name]
        else:
            out["post"], out["pre1"], out["pre2"] = raw.post, raw.pre1, raw.pre2
        out["mask"] = raw.mask.astype(np.int32)
        out["valid"] = raw.valid.astype(np.int32)
        if cfg.get("dem"):
            out["dem"] = (
                raw.dem.astype(np.float32)
                if raw.dem is not None
                else np.zeros(raw.post.shape[:2] + (1,), np.float32)
            )
        out["clz"] = np.int32(raw.clz)
        out["activation"] = np.int32(raw.activation)
        out["sample_weight"] = np.float32(1.0)
        return out

    def fill(self, arrays: dict, row: int, index: int) -> None:
        """Write the sample of ``records[index]`` into ``row`` of a batch
        buffer. Raises on a sample whose keys, shapes or dtypes differ from
        the buffer's (the first sample's), as ``np.stack`` would not."""
        sample = self.process(self.records[index])
        if sample.keys() != arrays.keys():
            raise ValueError(f"sample keys {sorted(sample)} differ from the batch's "
                             f"{sorted(arrays)} (record {self.records[index].id})")
        for k, v in sample.items():
            dst = arrays[k]
            v = np.asarray(v)
            if v.shape != dst.shape[1:] or v.dtype != dst.dtype:
                raise ValueError(f"{k} of record {self.records[index].id} is {v.dtype}"
                                 f"{v.shape}, the batch's {dst.dtype}{dst.shape[1:]}")
            dst[row] = v


_ALIGN = 4096


def _slot_layout(layout: dict, batch: int) -> tuple[dict, int]:
    """{key: (offset, shape, dtype)} of one batch buffer, each key 4 KiB
    aligned, and the buffer's byte size."""
    offsets, total = {}, 0
    for k, (shape, dtype) in layout.items():
        offsets[k] = (total, (batch,) + tuple(shape), np.dtype(dtype))
        nbytes = batch * int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        total += -(-nbytes // _ALIGN) * _ALIGN
    return offsets, max(total, _ALIGN)


def _views(raw, offsets: dict) -> dict[str, np.ndarray]:
    return {k: np.frombuffer(raw, dtype=dt, count=int(np.prod(shape)), offset=off).reshape(shape)
            for k, (off, shape, dt) in offsets.items()}


class BatchRing:
    """``slots`` batch buffers in shared memory (``multiprocessing``'s
    RawArray, which a worker process maps), each a dict of numpy views with
    the batch's keys, shapes and dtypes. ``acquire`` hands out a free slot
    once the upload that last read it has completed (the event ``release``
    was given); ``pin`` page-locks the buffers in place for the card's copy
    engine."""

    def __init__(self, layout: dict, batch: int, slots: int):
        self.offsets, self.nbytes = _slot_layout(layout, batch)
        self.raws = [multiprocessing.sharedctypes.RawArray("B", self.nbytes) for _ in range(slots)]
        self.arrays = [_views(raw, self.offsets) for raw in self.raws]
        self._events: list = [None] * slots
        self._pinned = False
        self.reset()

    def reset(self) -> None:
        """Every slot free (an epoch's start; no feeder is running)."""
        self._free: queue.Queue = queue.Queue()
        for slot in range(len(self.raws)):
            self._free.put(slot)

    def acquire(self, abandoned: threading.Event) -> int | None:
        while not abandoned.is_set():
            try:
                slot = self._free.get(timeout=0.5)
            except queue.Empty:
                continue
            event, self._events[slot] = self._events[slot], None
            if event is not None:
                event.synchronize()  # its upload has read the buffer
            return slot
        return None

    def release(self, slot: int, event=None) -> None:
        self._events[slot] = event
        self._free.put(slot)

    def pin(self) -> None:
        """Page-lock every buffer in place (``cudaHostRegister``), so a
        ``non_blocking`` upload from it is a DMA with no staging copy."""
        if self._pinned:
            return
        import ctypes

        import torch

        for raw in self.raws:
            err = torch.cuda.cudart().cudaHostRegister(ctypes.addressof(raw), self.nbytes, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of a {self.nbytes}-byte batch buffer "
                                   f"failed: cudaError {int(err)}")
        self._pinned = True

    def close(self) -> None:
        if self._pinned:
            import ctypes

            import torch

            for event in self._events:
                if event is not None:
                    event.synchronize()
            for raw in self.raws:
                torch.cuda.cudart().cudaHostUnregister(ctypes.addressof(raw))
            self._pinned = False


# the decode process's decoder and its views of the ring's buffers
_WORKER: tuple | None = None

# glibc's mallopt parameters and madvise's MADV_POPULATE_WRITE (Linux 5.14)
_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD, _MADV_POPULATE_WRITE = -1, -3, 23
_PAGE = 4096


def _prepare_worker_memory(raws: list) -> None:
    """A decode process's memory, set up once, so that a row costs what it
    costs in the main process where page faults and mappings are dear (on
    the card's host, the loader alone on a pack went from 467-485 to
    1,349-1,456 patches/s with this; PERF.md §6): glibc's malloc
    keeps the sample's temporaries (a few hundred KiB each) on its heap
    rather than mapping and unmapping each one (a fresh process's dynamic
    threshold sits at just their size), and the ring's pages are mapped
    before the first row is written."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if hasattr(libc, "mallopt"):
        libc.mallopt(_M_MMAP_THRESHOLD, 64 << 20)
        libc.mallopt(_M_TRIM_THRESHOLD, 256 << 20)
    for raw in raws:
        start = -(-ctypes.addressof(raw) // _PAGE) * _PAGE
        end = (ctypes.addressof(raw) + ctypes.sizeof(raw)) // _PAGE * _PAGE
        if end > start and libc.madvise(ctypes.c_void_p(start), ctypes.c_size_t(end - start),
                                        _MADV_POPULATE_WRITE) != 0:
            np.frombuffer(raw, np.uint8)[::_PAGE].sum()  # no such advice: map by reading


def _init_worker(decoder: SampleDecoder, raws: list, offsets: dict) -> None:
    global _WORKER
    _prepare_worker_memory(raws)
    _WORKER = (decoder, [_views(raw, offsets) for raw in raws])


def _fill_row(job: tuple) -> None:
    slot, row, index = job
    decoder, arrays = _WORKER
    decoder.fill(arrays[slot], row, index)


class DecodeProcesses:
    """``workers`` decode processes writing samples into the ring's rows.
    They fork from a forkserver (a clean process with no threads and no
    CUDA state) with this module preloaded, so they start in milliseconds
    and import none of the caller's modules."""

    def __init__(self, decoder: SampleDecoder, ring: BatchRing, workers: int):
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        self.pool = ctx.Pool(workers, _init_worker, (decoder, ring.raws, ring.offsets))

    def fill(self, slot: int, ids) -> Callable[[], None]:
        """Start the rows of one batch (``ids``: the decoder's sample index
        of each row, an int or a tuple); returns a wait that raises a
        worker's error."""
        jobs = [(slot, row, i if isinstance(i, tuple) else int(i)) for row, i in enumerate(ids)]
        job = self.pool.map_async(_fill_row, jobs, chunksize=1)
        return job.get

    def close(self) -> None:
        self.pool.terminate()
        self.pool.join()


class RingBatch(dict):
    """A batch whose arrays are views of a ring slot: valid until
    ``release(event)``, after which the slot is refilled once ``event`` (the
    upload that read it, or None) has completed."""

    def __init__(self, arrays: dict, release: Callable):
        super().__init__(arrays)
        self.release = release


def _shutdown(workers, ring: BatchRing) -> None:
    workers.close()
    ring.close()


# the ring's slots: device_prefetch's 2 batches in flight and the one being
# filled (fewer for an epoch of fewer batches)
RING_SLOTS = 3


class Loader:
    """Iterable over batches for one split."""

    # decode workers; a subclass may supply another with the same
    # ``fill(slot, ids) -> wait`` and ``close()``
    worker_class = DecodeProcesses

    def __init__(
        self,
        mode: str,
        config: dict,
        seed: int = 999,
        index_cache: dict | None = None,
        process_index: int | None = None,
        process_count: int | None = None,
    ):
        self.mode = mode
        self.config = config
        self.batch_size = int(config["batch_size"])
        self.process_index, self.process_count, self.local_batch_size = resolve_process_grid(
            self.batch_size, process_index, process_count)
        self.seed = seed
        self.workers = int(config.get("num_workers", 8)) or 1

        root = Path(config.get("root_path", "."))
        self.synthetic = bool(config.get("synthetic_data")) or not (root / "data").exists()

        if self.synthetic:
            if _needs_stats(config):
                # synthetic activation ids are in no per-activation stats table
                raise ValueError(
                    f"scale_input={config.get('scale_input')!r} needs per-activation "
                    "min/max stats, which do not exist for the synthetic data source "
                    "(corpus missing or synthetic_data=true); use scale_input="
                    "\"normalize\" or null for synthetic runs"
                )
            n = int(config.get("synthetic_size", {"train": 256, "val": 64, "test": 64}.get(mode, 64)))
            acts = config.get(f"{mode}_acts") or [130]
            self.records = synthetic_records(n, list(acts), seed)
            if config.get("task") == "diffusion-unsup":
                self.records = [dataclasses.replace(r, type=t) for r in self.records
                                for t in ("pre1", "pre2", "flood")]
            self.positive_records = [r for r in self.records if r.positive]
            self.negative_records = [r for r in self.records if not r.positive]
            self.stats = None
        else:
            # one GridIndex per split, shared across the three Loaders
            cache = index_cache if index_cache is not None else {}
            if mode not in cache:
                cache[mode] = GridIndex(mode, config)
            index = cache[mode]
            self.records = index.records
            self.positive_records = index.positive_records
            self.negative_records = index.negative_records
            self.stats = None
            if _needs_stats(config):
                # the stats corpus spans ALL splits (reference
                # update_min_max_stats walks train+val+test, Dataset.py:493-520)
                all_records = []
                for m in ("train", "val", "test"):
                    if m not in cache:
                        cache[m] = GridIndex(m, config)
                    all_records.extend(cache[m].records)
                self.stats = compute_min_max_stats(all_records, str(root), config)

        # packed shards (data/shards.py): one memmap slice per sample; a
        # record missing from the pack falls through to the tile or
        # synthetic decode
        self.shard_reader = None
        shard_root = config.get("packed_shards")
        if shard_root:
            from .shards import ShardReader

            split_dir = Path(shard_root) / mode
            if (split_dir / "manifest.json").is_file():
                self.shard_reader = ShardReader(split_dir)
                self.shard_reader.check_decode_config(config)  # a stale pack raises

        self.decoder = SampleDecoder(config, self.records, self.stats, seed, self.synthetic,
                                     self.shard_reader)
        self.oversampling = bool(config.get("oversampling")) and mode == "train"
        self._rng = epoch_rng(seed, mode)
        self._epoch = 0
        self._oversample_ids = None
        self._ring: BatchRing | None = None
        self._workers = None
        self._feeder: tuple | None = None  # (thread, abandoned) of the running epoch
        self._finalizer = None

    # -- sampling ---------------------------------------------------------
    def __len__(self):
        n = len(self.records)
        if self.mode == "train":
            return n // self.batch_size  # drop_last=True parity
        return -(-n // self.batch_size)

    def num_samples(self):
        return len(self.records)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.records)
        if self.mode != "train":
            return np.arange(n)
        if self.oversampling and self.negative_records and self.positive_records:
            # 50/50 positive/negative draws, seeded (Dataset.py:641-651); a
            # split with either side empty takes a plain shuffle
            if self._oversample_ids is None:
                by_id = {id(r): i for i, r in enumerate(self.records)}
                self._oversample_ids = (
                    np.asarray([by_id[id(r)] for r in self.positive_records]),
                    np.asarray([by_id[id(r)] for r in self.negative_records]),
                )
            pos_ids, neg_ids = self._oversample_ids
            coin = self._rng.integers(0, 2, n)
            pos_draw = pos_ids[self._rng.integers(0, len(pos_ids), n)]
            neg_draw = neg_ids[self._rng.integers(0, len(neg_ids), n)]
            return np.where(coin == 0, pos_draw, neg_draw)
        return self._rng.permutation(n)

    def _epoch_batches(self) -> list:
        """The next epoch's batches of sample indices; train drops the last
        partial batch (drop_last=True parity)."""
        indices = self._epoch_indices()
        self._epoch += 1
        bs = self.batch_size
        batches = [indices[i: i + bs] for i in range(0, len(indices), bs)]
        if self.mode == "train":
            batches = [b for b in batches if len(b) == bs]
        return batches

    # -- decode -----------------------------------------------------------
    def _read(self, record: Record) -> RawSample:
        return self.decoder.read(record)

    def _start(self) -> None:
        """The ring (its layout from the first record's sample) and the
        decode workers, once for the Loader's life."""
        if self._ring is not None:
            return
        if not self.synthetic:
            print(f"Loader {self.mode}: {self.num_samples()} samples, tile decoder "
                  f"{decoder_choice()}", flush=True)
        sample = self._first_sample()
        layout = {k: (np.shape(v), np.asarray(v).dtype) for k, v in sample.items()}
        self._ring = BatchRing(layout, self.local_batch_size,
                               max(1, min(RING_SLOTS, len(self))))
        self._workers = self.worker_class(self.decoder, self._ring, self.workers)
        self._finalizer = weakref.finalize(self, _shutdown, self._workers, self._ring)

    def _first_sample(self) -> dict:
        """A processed sample, whose keys, shapes and dtypes are the ring's."""
        return self.decoder.process(self.records[0])

    def close(self) -> None:
        """Stop the decode workers and release the ring (also done when the
        Loader is collected)."""
        self._stop_feeder()
        if self._finalizer is not None:
            self._finalizer()
        self._ring = self._workers = self._finalizer = None

    def _stop_feeder(self) -> None:
        if self._feeder is not None:
            thread, abandoned = self._feeder
            abandoned.set()
            thread.join()
            self._feeder = None

    # -- iteration --------------------------------------------------------
    def ring_batches(self, pin: bool = False) -> Iterator[RingBatch]:
        """One epoch of batches as views of the ring's slots; the consumer
        calls each batch's ``release`` once it has read it (or given it to an
        upload, with that upload's event). ``pin`` page-locks the ring for
        uploads to the card."""
        batches = self._epoch_batches()
        if not batches:
            return
        self._stop_feeder()
        self._start()
        ring = self._ring
        if pin:
            ring.pin()
        ring.reset()
        out: queue.Queue = queue.Queue()  # bounded by the ring's slots
        stop = object()
        abandoned = threading.Event()
        thread = threading.Thread(target=self._feed, args=(batches, out, stop, abandoned),
                                  daemon=True)
        self._feeder = (thread, abandoned)
        thread.start()
        try:
            while True:
                item = out.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield RingBatch(ring.arrays[item], lambda event=None, slot=item:
                                ring.release(slot, event))
        finally:
            abandoned.set()
            thread.join()
            if self._feeder is not None and self._feeder[0] is thread:
                self._feeder = None

    def _feed(self, batches, out: queue.Queue, stop, abandoned: threading.Event) -> None:
        """The feeder thread: take a free slot, start its rows on the
        workers, then finish the previous batch (wait, pad) and hand it on,
        so the workers go straight from one batch to the next. Errors are
        handed to the consumer, who raises them."""
        ring, pending = self._ring, None
        lo = self.process_index * self.local_batch_size
        try:
            for ids in batches:
                slot = ring.acquire(abandoned)
                if slot is None:
                    return
                ids = ids[lo:lo + self.local_batch_size]  # this process's rows of the batch
                done, pending = pending, (slot, len(ids), self._workers.fill(slot, ids))
                if done is not None:
                    self._finish(done)
                    out.put(done[0])
            if pending is not None:
                done, pending = pending, None
                self._finish(done)
                out.put(done[0])
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            out.put(e)
        finally:
            if pending is not None:  # an abandoned epoch: no write may outlive it
                try:
                    pending[2]()
                except Exception:  # noqa: BLE001 — the epoch is over; its error is moot
                    pass
            out.put(stop)

    def _finish(self, item: tuple) -> None:
        """Wait for a batch's rows; an eval batch's missing rows become
        zero-weight, all-ignore copies of its last sample (zero samples where
        the process's whole block is padding)."""
        slot, n, wait = item
        wait()
        if self.mode != "train" and n < self.local_batch_size:
            arrays = self._ring.arrays[slot]
            for arr in arrays.values():
                arr[n:] = arr[n - 1] if n else 0
            arrays["sample_weight"][n:] = 0
            if "mask" in arrays:  # absent from diffusion-unsup's typed records
                arrays["mask"][n:] = 3

    def __iter__(self) -> Iterator[dict]:
        """One epoch of batches, each its own arrays (a copy of its slot)."""
        for batch in self.ring_batches():
            copy = {k: v.copy() for k, v in batch.items()}
            batch.release()
            yield copy


def prepare_loaders(config: dict, seed: int = 999):
    """Train/val/test loader triple (utilities/utilities.py:73-126 parity;
    only the RandomEvents track is supported, like the reference)."""
    if config.get("track") not in ("RandomEvents",):
        raise ValueError("No such track! We currently support only RandomEvents")
    if config.get("slc"):
        from .slc import SLCLoader

        return (SLCLoader("train", config, seed), SLCLoader("val", config, seed),
                SLCLoader("test", config, seed))
    cache: dict = {}  # share split indices across the three Loaders
    return (
        Loader("train", config, seed, index_cache=cache),
        Loader("val", config, seed, index_cache=cache),
        Loader("test", config, seed, index_cache=cache),
    )
