"""Build and bind the port's hand-written CUDA kernels.

Each ``kurosiwo_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The build happens
at first use, all sources at once (one ``nvcc`` process each, started
together), into ``kurosiwo_torch/_build/<hash of the sources and flags>/``,
which ``.gitignore`` lists; a changed source gets a new directory. Nothing is
built or loaded when this module is imported.

Every C entry point returns ``cudaGetLastError()`` after its launches; the
wrappers pass it to :func:`check`, which raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def build() -> dict[str, float]:
    """Compile every source whose library is missing; returns the seconds
    each compile took (empty when everything was built already)."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    pending = {}
    for src in sources():
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[src.stem] = (proc, tmp, lib, time.perf_counter())
    seconds = {}
    failed = []
    for name, (proc, tmp, lib, t0) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        path = build_dir() / f"lib{name}.so"
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        lib.ks_error_string.argtypes = [ctypes.c_int]
        lib.ks_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.ks_error_string(err).decode()})")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
