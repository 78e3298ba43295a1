"""Native (C++) Matrix Market tokenizer.

The reference's runtime around the CUDA kernels is C/C++
(``/root/reference/src/core/*.c``, ``src/utils/mmread.cpp``); the native
component here is the parallel strict tokenizer behind
:func:`spgpu_tpu.io.read_mm`, compiled from :file:`mm_parse.cpp` on first
use with the system ``g++`` and bound via :mod:`ctypes`.  Everything
degrades gracefully to the pure-NumPy path when no compiler is available
(``SPGPU_TPU_NO_NATIVE=1`` forces the fallback).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "mm_parse"]

_lock = threading.Lock()
_lib = None
_tried = False

_SRC = os.path.join(os.path.dirname(__file__), "mm_parse.cpp")
_SO = os.path.join(os.path.dirname(__file__), "_libspgpu_native.so")


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("SPGPU_TPU_NO_NATIVE"):
            return None
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                tmp = f"{_SO}.{os.getpid()}.tmp"  # concurrent test workers
                try:  # OpenMP for the parallel chunk parse
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-fopenmp",
                         _SRC, "-o", tmp],
                        check=True, capture_output=True, timeout=120,
                    )
                except subprocess.CalledProcessError:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", _SRC,
                         "-o", tmp],
                        check=True, capture_output=True, timeout=120,
                    )
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.mm_parse.restype = ctypes.c_int64
            lib.mm_parse.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, i64p, i64p,
                ctypes.POINTER(ctypes.c_double)]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def mm_parse(buf: bytes, ntok: int, nnz: int):
    """Parallel strict tokenizer for a Matrix Market coordinate body.

    ``ntok`` = tokens per line (2 pattern / 3 real-integer / 4 complex);
    returns ``(rows, cols, vals)`` int64/int64/float64 arrays (``vals``
    shape ``(n, 2)`` for complex, ``(n,)`` real/integer, size 0
    pattern), or ``None`` when the native library is unavailable OR the
    body is malformed / line-misaligned (callers fall back to
    ``np.loadtxt``).  Row/col are returned 1-BASED as in the file."""
    lib = _load()
    if lib is None:
        return None
    if isinstance(buf, str):
        buf = buf.encode("ascii", errors="replace")
    nval = ntok - 2
    cap = nnz + 8
    rows = np.empty(cap, dtype=np.int64)
    cols = np.empty(cap, dtype=np.int64)
    vals = np.empty(cap * (2 if nval == 2 else 1) if nval else 1,
                    dtype=np.float64)
    n = lib.mm_parse(
        buf, len(buf), ntok, cap, _p(rows), _p(cols),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if n != nnz:
        return None
    if nval == 2:
        v = vals[: 2 * n].reshape(n, 2)
    elif nval == 1:
        v = vals[:n]
    else:
        v = vals[:0]
    return rows[:n], cols[:n], v
