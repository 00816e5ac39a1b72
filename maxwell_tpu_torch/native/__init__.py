"""Native (C++) host code of the port, loaded with ctypes: the same
native.cpp as maxwell_tpu/native (a byte-for-byte copy) and the same entry
points as that package's loader.

    level_schedule_levels  dependency levels of a triangular CSR
                           (kernels/tri_solve.py LevelSchedule.from_csr)
    ldlt_factor            sparse up-looking LDL^T of a symmetric matrix
                           (kernels/tri_solve.py SparseLDLTDevice.factor)
    bell_from_csr          CSR -> blocked-ELL fill

At first use the source is compiled with g++ -O3 -march=native into
build/maxwell_tpu_torch/ at the root of the checkout, named by a content hash
of the source, the flags and the host CPU's model and feature flags (a
library built for one CPU is not loaded on another, which may lack its
instructions): written under a temporary name, then renamed into place, so
a concurrent loader never reads half a file. If g++ is
missing or the build fails, `load()` raises with the compiler's output;
there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "maxwell_tpu_torch"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)
# argtypes of each entry point of native.cpp (each returns an int64)
_SIGNATURES = {
    "bell_from_csr": [ctypes.c_int64] * 3 + [_i64p, _i32p, _f64p, _f64p,
                                             _i32p],
    "level_schedule": [ctypes.c_int64, _i64p, _i32p, ctypes.c_int, _i64p],
    "ldlt_symbolic": [ctypes.c_int64, _i64p, _i32p, _i64p, _i64p],
    "ldlt_numeric": [ctypes.c_int64, _i64p, _i32p, _f64p, _i64p, _i64p,
                     _i32p, _f64p, _f64p],
}


def _cpu_tag() -> bytes:
    """The host CPU's model name and feature flags, which -march=native
    compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(lines[:2]).encode()
    except OSError:
        return platform.processor().encode()


def build() -> Path:
    """Compile native.cpp unless the library for this source and CPU
    exists."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_cpu_tag())
    out = BUILD_DIR / f"libmaxwell_native_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native host code "
                           f"({SRC}) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    cmd = [cxx, *FLAGS, "-o", str(tmp), str(SRC)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed with code {done.returncode}:\n{' '.join(cmd)}\n"
            f"{done.stdout}{done.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare the entry points' types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bell_from_csr(indptr, indices, data, n: int, b: int, S: int):
    """Fill blocked-ELL (blocks, cols) from CSR. Returns (blocks, cols,
    max_slots_used) with float64 blocks; the caller casts."""
    lib = load()
    nbr = n // b
    blocks = np.zeros((nbr, S, b, b), dtype=np.float64)
    cols = np.zeros((nbr, S), dtype=np.int32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float64)
    used = lib.bell_from_csr(
        n, b, S,
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_double), _ptr(blocks, ctypes.c_double),
        _ptr(cols, ctypes.c_int32),
    )
    if used < 0:
        raise ValueError("slot count S too small for matrix structure")
    return blocks, cols, int(used)


def level_schedule_levels(indptr, indices, n: int, lower: bool):
    """Row dependency levels of a triangular CSR. Returns (levels (n,)
    int64, number of levels)."""
    lib = load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    levels = np.zeros(n, dtype=np.int64)
    nl = lib.level_schedule(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        1 if lower else 0, _ptr(levels, ctypes.c_int64),
    )
    return levels, int(nl)


def ldlt_factor(A_upper_csc):
    """Sparse LDL^T of symmetric A given its upper triangle in CSC.

    Returns (Lp, Li, Lx, D) with L unit-lower in CSC (diagonal implicit).
    Raises ZeroDivisionError on a zero pivot.
    """
    import scipy.sparse as sp

    lib = load()
    A = sp.csc_matrix(A_upper_csc)
    A.sort_indices()
    n = A.shape[0]
    Ap = np.ascontiguousarray(A.indptr, dtype=np.int64)
    Ai = np.ascontiguousarray(A.indices, dtype=np.int32)
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)

    parent = np.zeros(n, dtype=np.int64)
    counts = np.zeros(n, dtype=np.int64)
    total = lib.ldlt_symbolic(
        n, _ptr(Ap, ctypes.c_int64), _ptr(Ai, ctypes.c_int32),
        _ptr(parent, ctypes.c_int64), _ptr(counts, ctypes.c_int64),
    )
    Lp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=Lp[1:])
    Li = np.zeros(total, dtype=np.int32)
    Lx = np.zeros(total, dtype=np.float64)
    D = np.zeros(n, dtype=np.float64)
    bad = lib.ldlt_numeric(
        n, _ptr(Ap, ctypes.c_int64), _ptr(Ai, ctypes.c_int32),
        _ptr(Ax, ctypes.c_double), _ptr(parent, ctypes.c_int64),
        _ptr(Lp, ctypes.c_int64), _ptr(Li, ctypes.c_int32),
        _ptr(Lx, ctypes.c_double), _ptr(D, ctypes.c_double),
    )
    if bad >= 0:
        raise ZeroDivisionError(f"zero pivot at column {bad}")
    return Lp, Li, Lx, D
