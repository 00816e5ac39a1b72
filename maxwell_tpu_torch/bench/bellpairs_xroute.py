"""The X-operand route of the BELLPairs SpMM body, measured both ways.

    python -m maxwell_tpu_torch.bench.bellpairs_xroute [--grid 24] [--ms 9 16]

Route (a), what csrc/bellpairs_spmm.cu does: each pair slot's X operand
(16 consecutive rows of X, 64 m bytes) is read as 4-byte fragment loads
from L2. Route (b): the slot's X rows are copied with 16-byte cp.async into
a per-warp shared-memory ring one step ahead of their use, and the mma
fragments are read from there (direct form, m <= 16). The script builds
csrc/bellpairs_spmm.cu and a copy patched to route (b) (`patched_source`)
with nvcc, side by side, holds both to the plain version on the RCM
brick's K/M layout, and times the fused K/M kernel (K12) and the
one-stream kernel on stream b (K11) at each m, the two routes in turns.
Route (b) is not an option of the kernel: this is the measurement that
chose route (a). Needs the card and nvcc; prints one JSON line per case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

# route (b), patched into a copy of csrc/bellpairs_spmm.cu: (anchor, text
# put before it, or in its place when the third item is True)
_RING = r'''
  // route (b): each step's X panels copied into a per-warp ring one step
  // ahead (16-byte cp.async), read back as the mma fragments
  __shared__ __align__(16) float xring[kWarpsPerCta][2][kUnrollMma][16 * 16];
  constexpr bool kRingX = kMma && W == 16 && MODE == kDirect;
  auto issue = [&](int s0, bool use_next) {
    if constexpr (kRingX) {
      const int buf = (s0 / kUnroll) & 1;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int sq = s0 + u;
        const int c = __shfl_sync(0xffffffffu, use_next ? col_nxt : col_cur,
                                  sq & (kColBatch - 1));
        if (sq < np) {
          const float* src = xs + (base + c) * kB * xld;
          float* dst = &xring[warp][buf][u][0];
          for (int k = lane; k < 4 * xld; k += 32) {
            const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 4 * k);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         ::"r"(d), "l"(src + 4 * k));
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
  };
  if constexpr (kRingX) issue(0, false);
'''
_STEP = r'''
    if constexpr (kRingX) {
      issue(s + kUnroll, ((s + kUnroll) & (kColBatch - 1)) == 0);
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncwarp();
    }
'''
_PATCH = (
    ("  for (int s = 0; s < np; s += kUnroll) {\n", _RING, False),
    ("    if constexpr (kMma) {\n#pragma unroll\n      for (int mt = 0; mt < MT;",
     _STEP, False),
    ("            const float* xp = xr[u] + e * xld;\n",
     "            const float* xp = kRingX\n"
     "                ? &xring[warp][(s / kUnroll) & 1][u][(4 * t + e) * xld]\n"
     "                : xr[u] + e * xld;\n", True),
    ("ldx<SMEM>(xp + j) : 0.f;", "(kRingX ? xp[j] : ldx<SMEM>(xp + j)) : 0.f;",
     True),
    ("ldx<SMEM>(xp + j + 8) : 0.f;",
     "(kRingX ? xp[j + 8] : ldx<SMEM>(xp + j + 8)) : 0.f;", True),
    ("#pragma unroll\n    for (int st = 0; st < NS; ++st)\n#pragma unroll\n"
     "      for (int u = 0; u < kUnroll; ++u) v[st][u] = vn[st][u];\n",
     "    if constexpr (kRingX) __syncwarp();\n", False),
)


def patched_source(src: str) -> str:
    """csrc/bellpairs_spmm.cu's text with route (b); raises if an anchor
    of the patch is not found once."""
    for anchor, text, replace in _PATCH:
        if src.count(anchor) != 1:
            raise ValueError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, text if replace else text + anchor)
    return src


def _build(src: str, out: Path):
    from maxwell_tpu_torch.kernels import _build as kb

    cu = out / "bellpairs_spmm.cu"
    cu.write_text(src)
    so = out / "lib.so"
    subprocess.run(
        [kb.find_nvcc(), *kb.NVCC_FLAGS, "-I", str(kb.SRC_DIR), "-shared",
         "-o", str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name in ("bellpairs_matmat_f32", "bellpairs_km_matmat_f32"):
        getattr(lib, name).argtypes = kb._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def run(grid: int = 24, ms=(9, 16)) -> list:
    """One row per (m, kernel, route): ms, max error over max|plain|."""
    import torch

    from maxwell_tpu_torch.bench.timing import median_ms
    from maxwell_tpu_torch.kernels import _build as kb
    from maxwell_tpu_torch.kernels import bellpairs_spmm as kp
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.bellpairs import BELLPairs
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    if not torch.cuda.is_available():
        raise RuntimeError("the route comparison runs on a CUDA device")
    if max(ms) > 16:
        raise ValueError("route (b) is patched for m <= 16")
    src = (kb.SRC_DIR / "bellpairs_spmm.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for route, text in (("a", src), ("b", patched_source(src))):
            (Path(tmp) / route).mkdir()
            libs[route] = _build(text, Path(tmp) / route)
        prob = PermutedProblem(BrickCavity3D(nx=grid, ny=grid, nz=grid))
        A = BELLPairs.from_csr(prob.K.tocsr(), B=prob.M.tocsr(),
                               device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        rows = []
        for m in ms:
            X = torch.randn(A.n_padded, m, device="cuda")
            want = kp.bellpairs_km_matmat_ref(A, X)
            for route in ("a", "b", "b", "a"):
                lib = libs[route]
                Yk, Ym = torch.empty_like(X), torch.empty_like(X)
                Yb = torch.empty_like(X)
                calls = {
                    "bellpairs_km_matmat": (lambda: lib.bellpairs_km_matmat_f32(
                        A.vals2d.data_ptr(), A.vals2d_b.data_ptr(),
                        A.cols.data_ptr(), A.npairs.data_ptr(), X.data_ptr(),
                        Yk.data_ptr(), Ym.data_ptr(), A.n_brows, A.slots, m,
                        stream), (Yk, Ym), want),
                    "bellpairs_matmat_b": (lambda: lib.bellpairs_matmat_f32(
                        A.vals2d_b.data_ptr(), A.cols.data_ptr(),
                        A.npairs.data_ptr(), X.data_ptr(), Yb.data_ptr(),
                        A.n_brows, A.slots, m, stream), (Yb,), want[1:]),
                }
                for kernel, (fn, got, ref) in calls.items():
                    if fn() != 0:
                        raise RuntimeError(f"route {route} launch failed")
                    torch.cuda.synchronize()
                    err = max(((g - w).abs().max() / w.abs().max()).item()
                              for g, w in zip(got, ref))
                    if not err <= 1e-5:
                        raise AssertionError(f"route {route} {kernel} m={m}: "
                                             f"{err:.2e} of max|plain|")
                    rows.append({"kernel": kernel, "route": route, "m": m,
                                 "ms": median_ms(fn), "rel_err": err})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=24)
    ap.add_argument("--ms", type=int, nargs="+", default=[9, 16])
    args = ap.parse_args(argv)
    import torch

    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for row in run(args.grid, tuple(args.ms)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
