"""ctypes bindings for the native tile decoder (``csrc/tile_decoder.cpp``);
the port's own copy of ``kurosiwo_tpu/data/native.py``.

``libks_tiles.so`` is built with ``g++`` at first use (about a second) into
``kurosiwo_torch/_build/tiles-<hash of the source>/``, which git ignores.
Where ``g++`` or libtiff (``libtiff.so.6`` or ``.so.5``, bound with dlopen)
is missing the decoder is unavailable and ``data/tiles._imread`` takes
cv2. The batch API decodes many GeoTIFFs in one call on a C++ thread pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tile_decoder.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_TRIED = False
_WHY = "not tried"
_INIT_LOCK = threading.Lock()


def _build_and_load():
    """The loaded library, built on the first call; thread-safe (two decode
    threads must not both run g++ into one file)."""
    global _LIB, _TRIED
    if _TRIED:  # _TRIED only flips under the lock
        return _LIB
    with _INIT_LOCK:
        if not _TRIED:
            _LIB = _build_and_load_locked()
            _TRIED = True
        return _LIB


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / f"tiles-{h}" / "libks_tiles.so"


def _build_and_load_locked():
    global _WHY
    so = library_path()
    try:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            # a temporary name, then a rename (atomic on POSIX): a process
            # loading the path never sees a partial file
            tmp = so.with_suffix(f".so.tmp.{os.getpid()}")
            subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE), "-ldl", "-lpthread"],
                           check=True, capture_output=True)
            tmp.replace(so)
        lib = ctypes.CDLL(str(so))
    except FileNotFoundError:
        _WHY = "g++ not found"
        return None
    except subprocess.CalledProcessError as e:
        _WHY = f"g++ failed: {e.stderr.decode(errors='replace')[-300:]}"
        return None
    except OSError as e:
        _WHY = f"the library did not load: {e}"
        return None
    lib.ks_available.restype = ctypes.c_int
    if not lib.ks_available():
        _WHY = "libtiff (libtiff.so.6 or .so.5) did not load"
        return None
    lib.ks_decode.restype = ctypes.c_int
    lib.ks_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ks_decode_batch.restype = None
    lib.ks_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    _WHY = f"built at {so}"
    return lib


def available() -> bool:
    return _build_and_load() is not None


def status() -> str:
    """Why the decoder is, or is not, available (after the first try)."""
    _build_and_load()
    return _WHY


def decode_tile(path: str, max_pixels: int = 1024 * 1024 * 4) -> np.ndarray:
    """Decode one GeoTIFF tile to float32 (H, W) or (H, W, C)."""
    lib = _build_and_load()
    if lib is None:
        raise RuntimeError(f"native tile decoder unavailable ({_WHY})")
    buf = np.empty(max_pixels, np.float32)
    h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.ks_decode(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
    )
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    arr = buf[: h.value * w.value * c.value].reshape(h.value, w.value, c.value).copy()
    return arr[..., 0] if c.value == 1 else arr


def decode_batch(paths: list[str], tile_pixels: int = 224 * 224 * 4,
                 threads: int = 0) -> list[np.ndarray]:
    """Decode many tiles concurrently; a list of float32 arrays."""
    lib = _build_and_load()
    if lib is None:
        raise RuntimeError(f"native tile decoder unavailable ({_WHY})")
    n = len(paths)
    out = np.empty((n, tile_pixels), np.float32)
    dims = np.zeros((n, 3), np.int32)
    rcs = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.ks_decode_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), tile_pixels,
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), threads,
    )
    results = []
    for i in range(n):
        if rcs[i] != 0:
            raise IOError(f"native decode failed ({rcs[i]}) for {paths[i]}")
        h, w, c = dims[i]
        a = out[i, : h * w * c].reshape(h, w, c).copy()
        results.append(a[..., 0] if c == 1 else a)
    return results
