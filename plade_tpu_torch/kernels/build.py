"""Build and load the package's CUDA library at first use.

The sources under ``plade_tpu_torch/csrc/`` are compiled with ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library is
keyed by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded from ``plade_tpu_torch/_build/``.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("nn.cu", "cc.cu", "knn.cu", "penetration.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC",
              # the kernels' d2 must round like the plain PyTorch version
              # (no fused multiply-add); see csrc/nn.cu
              "-fmad=false")

#: kernel launches per kernel, counted by the wrappers where they launch and
#: nowhere else (:func:`count_launch`): a run resets the counts and reads
#: them to show that its path went through the kernels
LAUNCHES = {"nearest_neighbor": 0, "oriented_min_dist_sq": 0,
            "close_and_label_lanes": 0, "topk_dist_sq": 0,
            "penetration_walk": 0}
#: the shards of a mesh launch from host threads of their own: the counts'
#: read-modify-write and the first build of the library hold this lock
_LOCK = threading.Lock()


#: per thread, the launches made while a CUDA graph is captured there
#: (:func:`captured_launches`)
_CAPTURING = threading.local()


def count_launch(name: str):
    """Count one launch of kernel ``name``; inside
    :func:`captured_launches` keep it instead: a capture records the launch
    and runs nothing."""
    held = getattr(_CAPTURING, "names", None)
    if held is not None:
        held.append(name)
        return
    with _LOCK:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def captured_launches():
    """``with captured_launches() as names:`` around a CUDA graph's
    capture: the launches this thread counts inside the block are listed in
    ``names`` and not counted; :func:`credit_launches` counts them at each
    replay of the graph."""
    prev = getattr(_CAPTURING, "names", None)
    _CAPTURING.names = names = []
    try:
        yield names
    finally:
        _CAPTURING.names = prev


def credit_launches(names):
    """Count one launch of each kernel of ``names`` (a replayed graph's)."""
    with _LOCK:
        for name in names:
            LAUNCHES[name] += 1

_P = ctypes.c_void_p
_SIGNATURES = {
    # q, r, out_d, out_i, keys (P x Q 64-bit scratch), P, Q, T, stream
    "plade_nearest_neighbor": (_P, _P, _P, _P, _P, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, _P),
    # q, qn, r, rn, normal_cos, out_d, P, Q, T, stream
    "plade_oriented_min_dist_sq": (_P, _P, _P, _P, ctypes.c_float, _P,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   _P),
    # P, Q, T, oriented -> reference slices of a K2 (0) or K1 (1) launch
    "plade_nn_ref_slices": (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int),
    # q, qq, r, rr, out, scratch, P, Q, T, k, slice, stream
    "plade_topk_dist_sq": (_P, _P, _P, _P, _P, _P, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _P),
    # P, Q, T, k -> references a slice of a K4 launch
    "plade_topk_slice": (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int),
    # cand, src, tgt, start, direc, length, valid, R, t, src_pts,
    # src_counts, tgt_pts, tgt_counts, src_coeffs, tgt_coeffs, radius, min_d,
    # r_occ, r_near, out, counts (or NULL), B, K, C, Ps, Pt, M, S,
    # min_points, max_ratio, stream
    "plade_penetration_walk": (*(_P,) * 21, *(ctypes.c_int,) * 8,
                               ctypes.c_float, _P),
    # occ, out, L, G, iters, stream
    "plade_close_and_label": (_P, _P, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, _P),
}


def find_nvcc() -> str:
    """Path of ``nvcc`` from ``CUDA_HOME`` or ``PATH``; raises if absent."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the plade_tpu_torch CUDA kernels")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails.  Returns the concatenated compiler output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    report = []
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        report.append(out + err)
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                      f"\n{out}\n{err}")
    if failed:
        raise RuntimeError(failed)
    return "".join(report)


def build(verbose: bool = False) -> Path:
    """Compile the sources (if this exact build is not there yet) and return
    the library's path.  ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libplade_kernels_{_source_hash()}.so"
    if lib.is_file() and not verbose:
        return lib
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    try:
        report = _run([[nvcc, *NVCC_FLAGS,
                        *(["-Xptxas", "-v"] if verbose else []),
                        "-c", "-o", str(obj), str(CSRC / src)]
                       for src, obj in zip(SOURCES, objs)])
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if verbose:
        print(report)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (once, whichever
    thread calls first)."""
    with _LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
