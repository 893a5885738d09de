"""ctypes bindings for the native C++ PLY IO (plade_tpu_torch/native/ply_io.cpp).

A copy of ``plade_tpu/io/native.py`` that builds and loads the port's own
copy of the library.  Builds ``libplade_io.so`` with make on first use when
a toolchain is available (under a lock on the Makefile, so that processes
starting together build it once and never load a half-written library);
callers fall back to the numpy reader otherwise (io/ply.py keeps working
everywhere).  The native path adds the mmap fast-parse and the pthread
batch preloader the reference lacks (its batch mode loads pairs serially —
code/PLADE/main.cpp:97-158).
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native")
_SO = os.path.join(_DIR, "libplade_io.so")
_lib = None
_checked = False


def _build() -> bool:
    """Build the library unless it is there; False when make fails."""
    with open(os.path.join(_DIR, "Makefile")) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_SO):
            return True
        try:
            subprocess.run(["make", "-C", _DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return False
        return os.path.exists(_SO)


def _load():
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.plade_ply_read.restype = ctypes.c_int
    lib.plade_ply_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.plade_ply_write.restype = ctypes.c_int
    lib.plade_ply_write.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.plade_ply_read_batch.restype = ctypes.c_int
    lib.plade_ply_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.plade_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _take(lib, ptr, n):
    """Copy a malloc'd float* of 3n floats into numpy and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(n, 3)).copy()
    lib.plade_free(ptr)
    return arr


def read_ply(path: str):
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO unavailable")
    pts = ctypes.POINTER(ctypes.c_float)()
    nrm = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long()
    has_n = ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    rc = lib.plade_ply_read(path.encode(), ctypes.byref(pts),
                            ctypes.byref(nrm), ctypes.byref(n),
                            ctypes.byref(has_n), err, 256)
    if rc != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    points = _take(lib, pts, n.value)
    normals = _take(lib, nrm, n.value) if has_n.value else None
    return points, normals


def write_ply(path: str, points: np.ndarray,
              normals: np.ndarray | None = None, binary: bool = True):
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO unavailable")
    points = np.ascontiguousarray(points, dtype=np.float32)
    pp = points.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    np_ = None
    if normals is not None:
        normals = np.ascontiguousarray(normals, dtype=np.float32)
        np_ = normals.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    err = ctypes.create_string_buffer(256)
    rc = lib.plade_ply_write(path.encode(), pp, np_, points.shape[0],
                             1 if binary else 0, err, 256)
    if rc != 0:
        raise ValueError(f"{path}: {err.value.decode()}")


def read_ply_batch(paths: list[str], n_threads: int = 0):
    """Threaded parallel read; returns list of (points, normals) or None."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO unavailable")
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    pts = (ctypes.POINTER(ctypes.c_float) * n)()
    nrm = (ctypes.POINTER(ctypes.c_float) * n)()
    counts = (ctypes.c_long * n)()
    has_n = (ctypes.c_int * n)()
    status = (ctypes.c_int * n)()
    lib.plade_ply_read_batch(c_paths, n, n_threads, pts, nrm, counts, has_n,
                             status)
    out = []
    for i in range(n):
        if status[i] != 0:
            out.append(None)
            continue
        p = _take(lib, pts[i], counts[i])
        nn = _take(lib, nrm[i], counts[i]) if has_n[i] else None
        out.append((p, nn))
    return out
