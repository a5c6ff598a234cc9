"""ctypes bridge to the optional C++ IO/runtime accelerator.

The reference's runtime layer is native C++ (Open3D IO, FLANN trees,
OpenMP loops).  The device compute path here is XLA/Pallas, but the host
runtime around it (bulk file IO, benchmark data staging) has a native
C++ counterpart in ``native/se3io.cpp``, built by ``native/Makefile``
into ``native/libse3io.so``.  Everything degrades gracefully to numpy
when the library has not been built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CANDIDATES = [
    os.path.join(_HERE, "native", "libse3io.so"),
    os.path.join(os.path.dirname(__file__), "libse3io.so"),
]


def _try_build() -> None:
    """Build the library in place if the toolchain is present (a fresh
    checkout has no .so; without this, every PLY read silently took the
    numpy fallback).  Failures are non-fatal -- the fallback remains."""
    import subprocess
    try:
        subprocess.run(["make", "-C", os.path.join(_HERE, "native")],
                       check=True, capture_output=True, timeout=120)
    except Exception:
        pass


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SE3_ICP_NO_NATIVE"):
        return None
    if not any(os.path.exists(c) for c in _CANDIDATES):
        _try_build()
    for cand in _CANDIDATES:
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
                lib.se3io_read_block.restype = ctypes.c_longlong
                lib.se3io_read_block.argtypes = [
                    ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_void_p,
                ]
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def available() -> bool:
    return _load() is not None


def read_fixed_block(path, offset: int, count: int,
                     dtype: np.dtype) -> np.ndarray:
    """Read ``count`` records of ``dtype`` starting at byte ``offset``."""
    lib = _load()
    nbytes = count * dtype.itemsize
    out = np.empty(count, dtype=dtype)
    got = lib.se3io_read_block(
        str(path).encode(), int(offset), int(nbytes),
        out.ctypes.data_as(ctypes.c_void_p))
    if got != nbytes:
        raise ValueError(f"{path}: truncated read ({got} != {nbytes})")
    return out


def pack_pairs_f32(clouds, bucket: int):
    """OpenMP-parallel sanitize+pad+cast of a list of [len,3] float64
    clouds into a zero-padded float32 arena [n, bucket, 3] (+ kept-row
    counts).  Returns None when the native library is unavailable (the
    caller falls back to the numpy path)."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "se3io_pack_pairs"):
        return None
    if not hasattr(pack_pairs_f32, "_typed"):
        lib.se3io_pack_pairs.restype = ctypes.c_longlong
        lib.se3io_pack_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ]
        pack_pairs_f32._typed = True
    n = len(clouds)
    arrs = [np.ascontiguousarray(c, dtype=np.float64).reshape(-1, 3)
            for c in clouds]
    ptrs = (ctypes.c_void_p * n)(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs])
    lens = (ctypes.c_longlong * n)(*[len(a) for a in arrs])
    out = np.empty((n, bucket, 3), np.float32)
    counts = np.empty(n, np.int32)
    got = lib.se3io_pack_pairs(
        ptrs, lens, n, bucket, out.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p))
    if got < 0:
        return None
    return out, counts
