"""Build and load the package's CUDA library at first use.

The sources under ``plade_tpu_torch/csrc/`` are compiled with ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library is keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded from ``plade_tpu_torch/_build/``.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("nn.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              # the kernels' d2 must round like the plain PyTorch version
              # (no fused multiply-add); see csrc/nn.cu
              "-fmad=false")

_P = ctypes.c_void_p
_SIGNATURES = {
    # q, r, out_d, out_i, Q, T, stream
    "plade_nearest_neighbor": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                               _P),
    # q, qn, r, rn, normal_cos, out_d, Q, T, stream
    "plade_oriented_min_dist_sq": (_P, _P, _P, _P, ctypes.c_float, _P,
                                   ctypes.c_int, ctypes.c_int, _P),
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


def build(verbose: bool = False) -> Path:
    """Compile the sources (if this exact build is not there yet) and return
    the library's path.  ``verbose`` adds ``-Xptxas -v`` and returns the
    compiler's report on stdout."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libplade_kernels_{_source_hash()}.so"
    if lib.is_file() and not verbose:
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
