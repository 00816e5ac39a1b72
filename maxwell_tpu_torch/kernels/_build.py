"""Build and load the CUDA kernels of maxwell_tpu_torch/csrc.

At first use, `load()` compiles every csrc/*.cu with nvcc for sm_90a (one
nvcc process per source, all started together), links the objects into one
shared library with a plain C interface, and loads it with ctypes. The
library lands in build/maxwell_tpu_torch/ at the root of the checkout, named
by a content hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused. ptxas's register and spill report is kept
beside it (`<library>.log`).

nvcc is found through torch.utils.cpp_extension.CUDA_HOME, then PATH. If it
is missing or the build fails, `load()` raises with the compiler output;
nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "maxwell_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int64
# argtypes of each C entry point in csrc/*.cu
_SIGNATURES = {
    # bellunion_spmm.cu
    "bellunion_matmat_f32": [_P] * 10 + [_I] * 5 + [_P],
    "bellunion_matmat_b3": [_P] * 11 + [_I] * 5 + [_P],
    "bellunion_km_matmat_f32": [_P] * 12 + [_I] * 5 + [_P],
    "bellunion_km_matmat_b3": [_P] * 14 + [_I] * 5 + [_P],
    # bellpairs_spmm.cu
    "bellpairs_matmat_f32": [_P] * 5 + [_I] * 3 + [_P],
    "bellpairs_km_matmat_f32": [_P] * 7 + [_I] * 3 + [_P],
    "bellpairs_matmat_windowed_f32": [_P] * 6 + [_I] * 5 + [_P],
    # bsr_spmm.cu
    "bsr_matmat_f32": [_P] * 5 + [_I] * 3 + [_P],
    "bsr_matmat_windowed_f32": [_P] * 6 + [_I] * 5 + [_P],
    # stencil_taps.cu
    "stencil_taps_f32": [_P] * 8,
    # halo.cu
    "ring_shift": [_P] * 4 + [_I] * 11 + [_P],
    "union_overlap_f32": [_P] * 15 + [_I] * 14 + [_P],
    "ipc_alloc": [_I] * 2 + [_P] * 2,
    "ipc_open": [_P, _I, _P],
    "ipc_close": [_P, _I],
    "ipc_free": [_P, _I],
    # union_probes.cu
    "union_panel_f32": [_P] * 5 + [_I] * 4 + [_P],
    "union_panel_bf16": [_P] * 4 + [_I] * 4 + [_P],
    "union_unstaged_f32": [_P] * 10 + [_I] * 4 + [_P],
    "union_panel_shape": [_I] * 3 + [_P],
    # grid_probes.cu
    "grid_copy_f32": [_P] * 2 + [_I] * 2 + [_P],
    "grid_steps_f32": [_P] * 3 + [_I] * 2 + [_P],
    "grid_cat_f32": [_P] * 3 + [_I] * 4 + [_P],
    "grid_cat_mm_f32": [_P] * 4 + [_I] * 4 + [_P],
    "grid_rows_shape": [_I, _P],
    # stencil_probes.cu
    "shift_probe_f32": [_P] * 2 + [_I, _P, _I, _P],
    "shift_probe_shape": [_I] * 3 + [_P],
    # gather_probes.cu
    "gather_sum_f32": [_P] * 5 + [_I] * 8 + [_P],
    "gather_sum_shape": [_I] * 3 + [_P],
    "l2_read_f32": [_P] * 2 + [_I] * 2 + [_P],
    "gather_taa0_f32": [_P] * 3 + [_I] * 6 + [_P],
    "gather_taa1_f32": [_P, _I, _P, _P] + [_I] * 4 + [_P],
    "gather_taa_shape": [_I] * 2 + [_P],
    "gather_taa1_wide_f32": [_P] * 3 + [_I] * 3 + [_P],
    # spmm_probes.cu
    "spmm_probe_f32": [_P] * 4 + [_I] * 4 + [_P],
    "spmm_probe_bf16": [_P] * 4 + [_I] * 3 + [_P],
    "spmm_union_bf16": [_P] * 6 + [_I] * 6 + [_P],
    "spmm_def_shape": [_I] * 3 + [_P],
    "spmm_stream_tensor_map": [_P] + [_I] * 3 + [_P],
    "spmm_stream_bf16": [_P] * 3 + [_I] * 4 + [_P],
    # tri_solve.cu
    "level_solve_f32": [_P] * 10 + [_I] * 3 + [_P],
    "level_solve_f64": [_P] * 10 + [_I] * 3 + [_P],
    "level_chain_f32": [_P] + [_I] * 3 + [_P],
    "level_solve_shape": [_I] * 2 + [_P],
}


def find_nvcc() -> str:
    """Path of nvcc from CUDA_HOME (as torch resolved it) or PATH."""
    from torch.utils import cpp_extension

    home = cpp_extension.CUDA_HOME
    if home:
        cand = os.path.join(home, "bin", "nvcc")
        if os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (torch.utils.cpp_extension.CUDA_HOME="
        f"{home!r}, and none on PATH): the CUDA kernels cannot be built"
    )


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    sources = sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libmaxwell_tpu_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.tmp{os.getpid()}"
    objs, procs = [], []
    for src in (s for s in sources if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    tmp = BUILD_DIR / f"{tag}.so"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    try:
        log = []
        for cmd, proc in procs:
            text = proc.communicate()[0]
            _check(cmd, proc.returncode, text)
            log.append(f"$ {' '.join(cmd)}\n{text}")
        done = subprocess.run(link, capture_output=True, text=True)
        _check(link, done.returncode, done.stdout + done.stderr)
    finally:
        for cmd, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _check(cmd, returncode: int, text: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {returncode}:\n{' '.join(cmd)}\n{text}"
        )


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points' types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
