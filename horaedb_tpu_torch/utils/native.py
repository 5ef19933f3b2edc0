"""Native (C++) acceleration loader.

The reference's write path is native Rust end-to-end; here the Python
orchestration calls into ``libhoraedb_native.so`` (built from ``native/``)
for the batch-hashing hot path, with a pure-Python fallback when the
library isn't built. The library is compiled on demand with g++ the first
time it's needed (cached next to the sources).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("horaedb_tpu_torch.native")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libhoraedb_native.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "xxhash64.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # Compile to a private temp name then rename atomically: concurrent
    # builders in other processes never expose a half-written .so, and a
    # live process that already dlopen'd the old file keeps its mapping
    # (rename unlinks, not truncates).
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC_PATH],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception as e:  # no g++, compile error, read-only fs...
        logger.info("native build unavailable (%s); using pure-Python path", e)
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or (
            os.path.exists(_SRC_PATH)
            and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH)
        ):
            if not os.path.exists(_SRC_PATH) or not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            logger.info("native load failed (%s); using pure-Python path", e)
            return None
        lib.hash_var_xx64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.hash_fixed_xx64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.fnv_mix.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def hash_var(data, offsets: np.ndarray) -> np.ndarray:
    """XXH64 of each [offsets[i], offsets[i+1]) slice of ``data``.

    ``data`` may be bytes or any uint8 buffer (e.g. a zero-copy view of
    an arrow string column's data buffer)."""
    lib = load()
    n = len(offsets) - 1
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out
    if lib is None:
        import xxhash

        for i in range(n):
            out[i] = xxhash.xxh64_intdigest(data[offsets[i]:offsets[i + 1]])
        return out
    buf = (
        data
        if isinstance(data, np.ndarray)
        else np.frombuffer(data, dtype=np.uint8)
    )
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    lib.hash_var_xx64(_ptr(buf), _ptr(offs), n, _ptr(out))
    return out


def hash_fixed(data: np.ndarray) -> np.ndarray:
    """XXH64 of each row of a contiguous fixed-width array."""
    lib = load()
    data = np.ascontiguousarray(data)
    n = len(data)
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out
    if lib is None:
        import xxhash

        raw = data.tobytes()
        k = data.dtype.itemsize
        for i in range(n):
            out[i] = xxhash.xxh64_intdigest(raw[i * k:(i + 1) * k])
        return out
    lib.hash_fixed_xx64(_ptr(data), data.dtype.itemsize, n, _ptr(out))
    return out


def fnv_mix(acc: np.ndarray, col: np.ndarray) -> None:
    """In-place ``acc = (acc ^ col) * FNV_PRIME`` (wrapping u64)."""
    lib = load()
    if lib is None or len(acc) == 0:
        prime = np.uint64(0x100000001B3)
        np.multiply(np.bitwise_xor(acc, col), prime, out=acc)
        return
    # Keep the (possibly copied) array referenced until the call returns.
    col_c = np.ascontiguousarray(col, dtype=np.uint64)
    lib.fnv_mix(_ptr(acc), _ptr(col_c), len(acc))
