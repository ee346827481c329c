"""Build and load the port's CUDA kernels.

Each source in accl_tpu_torch/csrc/ is compiled by nvcc for sm_90a into a
shared library with a plain C interface, at first use, into
accl_tpu_torch/_build/ (listed in .gitignore), and loaded with ctypes.
The library name carries a digest of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. No network,
no ninja and no PyTorch headers are involved, which keeps a build to
seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# per library: seconds the nvcc run took in this process (0.0 when an
# up-to-date library was found on disk) and what ptxas reported
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of accl_tpu_torch are built on "
        "the machine with the card (CUDA toolkit on PATH or under "
        "/usr/local/cuda)")


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing, then load it."""
    return load_libraries([name])[name]


def load_libraries(names: list[str]) -> dict[str, ctypes.CDLL]:
    """Compile every missing library of `names` at once (one nvcc each,
    all started together), then load them all."""
    with _lock:
        todo = [n for n in names if n not in _loaded]
        builds = {}
        for name in todo:
            path = library_path(name)
            if path.exists():
                build_seconds[name] = 0.0
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            builds[name] = (proc, tmp, path, time.perf_counter())
        failed = []
        for name, (proc, tmp, path, t0) in builds.items():
            build_log[name] = proc.communicate()[0]
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(name)
            else:
                os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(
                f"csrc/{n}.cu:\n{build_log[n]}" for n in failed))
        for name in todo:
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return {n: _loaded[n] for n in names}
