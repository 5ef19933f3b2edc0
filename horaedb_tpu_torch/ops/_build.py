"""Build and load the port's CUDA kernels at first use.

Each ``ops/csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``horaedb_tpu_torch/_build/``
(listed in ``.gitignore``), named by the hash of its source so an edited
kernel rebuilds. The library loads with ``ctypes``. A failed build raises:
there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _build(src: str, out: str) -> tuple[float, str]:
    """Compile ``src`` into ``out``; returns (seconds, the compiler's
    report: registers and spills per instantiation)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``ops/csrc/<name>.cu``, built on first use.

    The library carries ``build_seconds`` and ``build_log`` (0.0 and ""
    when an earlier build of the same source was found)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src, out = _target(name)
            secs, log = _build(src, out) if not os.path.exists(out) else (0.0, "")
            lib = ctypes.CDLL(out)
            lib.build_seconds, lib.build_log = secs, log
            _libs[name] = lib
        return lib
