"""Chip smoke test of maxwell_tpu_torch on one NVIDIA GPU: build the CUDA
kernels from the sources in this checkout, hold each against its plain
PyTorch version at the shapes of the 24^3 operator, then drive the port's
main path (maxwell_tpu_torch.solve on the 24^3 RCM Nedelec brick, refined to
1e-8) and check that it ran through the kernels.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:
  1. device   name, nvidia-smi name and power limit, CUDA and nvcc versions
  2. build    nvcc build of maxwell_tpu_torch/csrc (seconds)
  3. kernels  every union kernel against its plain version on the card, for
              precision in {highest, b3} and m in {1, 8, 9}; one JSON line
              per case with median times over 20 launches (CUDA events);
              m = 8 also against scipy in f64 on the host
  4. solve    the main path, solve() to 1e-8, with launch counts zeroed
              just before it and read just after; then, counted apart, each
              eigenvector's residual through the SpMV entry point on the card
  5. result   an {"off_main_path": [...]} line for the SpMV entry point
              (which solve() does not call), the {"kernels": [...]} line of
              the main path's kernels, the nvidia-smi line, and last
              {"ok": true, "device": {...}}
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

GRID = 24  # the 24^3 RCM curl-curl operator: n = 38,088, nnz = 1,173,840
NEV = 5
LAUNCHES = 20
# f32 summation order differs from the plain version's (cuBLAS bmm +
# index_add_); the JAX package's own tests use the same bounds
TOL = {"highest": 1e-5, "b3": 2e-5}
# residual of a refined eigenvector recomputed with f32 applies on the card:
# its floor is ~eps_f32 * ||K|| ||x|| / ||Kx|| ~ 1e-5 at 24^3; a wrong vector
# gives O(1)
DEVICE_RESIDUAL_TOL = 1e-3
SOURCE = "maxwell_tpu_torch/csrc/bellunion_spmm.cu"
REPLACES = {
    "bellunion_matmat": "maxwell_tpu/kernels/spmm.py:304",
    "bellunion_km_matmat": "maxwell_tpu/kernels/spmm.py:466",
    "bellunion_matvec": "maxwell_tpu/kernels/spmm.py:900",
}
# what solve() launches: the fused apply (LOBPCG's W, the preconditioner's
# CG) and the single-stream apply (projector, initial SVQB). The SpMV entry
# point is the m = 1 launch of the single-stream kernel; no solver calls it.
MAIN_PATH = ("bellunion_km_matmat", "bellunion_matmat")


def log(obj):
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, n=LAUNCHES):
    """Median of n launches, each timed by its own pair of CUDA events."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        sys.exit(1)
    from maxwell_tpu_torch.kernels import _build

    nvcc = subprocess.run(
        [_build.find_nvcc(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    log(f"device: {torch.cuda.get_device_name(0)}")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvcc: {nvcc}")


def phase_build():
    from maxwell_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "library": lib.name})


def phase_kernels(problem):
    """Each kernel against its plain version at the 24^3 shapes. Returns
    (layout, per-kernel stats at the main path's shape)."""
    from maxwell_tpu_torch.kernels import spmm
    from maxwell_tpu_torch.sparse.bellunion import BELLUnion

    dev = torch.device("cuda")
    K, M = problem.K.tocsr(), problem.M.tocsr()
    n, nnz = K.shape[0], K.nnz
    t0 = time.perf_counter()
    A = BELLUnion.from_csr(K, B=M, device=dev).bf16x3()
    torch.cuda.synchronize()
    log({"phase": "layout", "n": n, "nnz": nnz, "chunks": A.n_chunks,
         "tiles": A.n_tiles, "value_bytes_per_stream": A.nnz_dense * 4,
         "build_s": time.perf_counter() - t0})
    if (n, nnz) != (38088, 1173840):
        raise AssertionError(f"unexpected 24^3 operator: n={n}, nnz={nnz}")

    rng = np.random.default_rng(0)
    stats = {name: {"max_abs_err": 0.0} for name in REPLACES}
    for precision in ("highest", "b3"):
        for m in (1, 8, 9):
            Xh = np.zeros((A.n_padded, m), np.float32)
            Xh[:n] = rng.standard_normal((n, m))
            X = torch.from_numpy(Xh).to(dev)
            x = X[:, 0].contiguous()
            cases = {
                "km": (
                    lambda: spmm.bellunion_km_matmat(A, X, precision),
                    lambda: spmm.bellunion_km_matmat_ref(A, X, precision),
                    "bellunion_km_matmat", 2,
                ),
            }
            for s in "ab":
                if m == 1:
                    cases[s] = (
                        lambda s=s: spmm.bellunion_matvec(A, x, s, precision),
                        lambda s=s: spmm.bellunion_matvec_ref(
                            A, x, s, precision),
                        "bellunion_matvec", 1,
                    )
                else:
                    cases[s] = (
                        lambda s=s: spmm.bellunion_matmat(A, X, s, precision),
                        lambda s=s: spmm.bellunion_matmat_ref(
                            A, X, s, precision),
                        "bellunion_matmat", 1,
                    )
            for case, (kern, plain, name, streams) in cases.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                abs_err = max((g - w).abs().max().item()
                              for g, w in zip(got, want))
                scale = max(w.abs().max().item() for w in want)
                if not abs_err <= TOL[precision] * scale:
                    raise AssertionError(
                        f"{name} {case} m={m} {precision}: max error "
                        f"{abs_err:.3e} > {TOL[precision]} * {scale:.3e}"
                    )
                ms, plain_ms = median_ms(kern), median_ms(plain)
                nbytes = (
                    streams * A.nnz_dense * 4  # values (f32 or bf16 hi+lo)
                    + A.ucols.numel() * 4
                    + A.n_chunks * A.cl * m * 4  # gathered X
                    + streams * A.n_padded * m * 4  # Y
                )
                row = {
                    "kernel": name, "case": case, "precision": precision,
                    "m": m, "max_abs_err": abs_err, "rel_err": abs_err / scale,
                    "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                    "GB_per_s": nbytes / ms / 1e6,
                    # nnz of the operator(s) applied per second, the
                    # reference bench's convention (one count per call)
                    "csr_nnz_per_s": streams * nnz / (ms * 1e-3),
                }
                log(row)
                st = stats[name]
                st["max_abs_err"] = max(st["max_abs_err"], abs_err)
                # the shapes the main path gives each kernel: the solve's
                # b3 block applies at m = 9, the residual check's SpMV
                main = (
                    (name == "bellunion_matvec" and precision == "highest"
                     and case == "a")
                    or (name != "bellunion_matvec" and precision == "b3"
                        and m == 9 and case in ("km", "a"))
                )
                if main:
                    st.update(ms=ms, plain_ms=plain_ms)
            if m == 8:
                ref = K @ Xh[:n].astype(np.float64)
                Y = spmm.bellunion_matmat(A, X, "a", precision)
                err = np.abs(Y[:n].cpu().numpy() - ref).max()
                if not err <= TOL[precision] * np.abs(ref).max():
                    raise AssertionError(f"K @ X vs scipy: {err:.3e}")
                log({"check": "scipy_f64", "precision": precision, "m": m,
                     "rel_err": float(err / np.abs(ref).max())})
    return A, stats


def phase_solve(problem, A):
    """The main path: solve() on the card, with launch counts zeroed just
    before and read just after. Then, counted on their own, each refined
    eigenvector's residual through the SpMV entry point, which solve() does
    not call. Returns (main-path counts, residual-check counts)."""
    import maxwell_tpu_torch
    from maxwell_tpu_torch.kernels import spmm
    from maxwell_tpu_torch.problems.analytic import cavity_eigenvalues_3d
    from maxwell_tpu_torch.solvers.operator import Pencil

    spmm.reset_counts()
    t0 = time.perf_counter()
    res = maxwell_tpu_torch.solve(
        problem, nev=NEV, tol=1e-8, dtype=torch.float32, device="cuda",
        maxiter=120, stall_window=12,
    )
    wall = time.perf_counter() - t0
    counts = spmm.counts()

    check = Pencil(K=A, kernel="union", precision="highest")
    spmm.reset_counts()
    dev_res = []
    for i, lam in enumerate(res.eigenvalues):
        x = torch.from_numpy(res.eigenvectors[:, i].astype(np.float32)).cuda()
        kx, mx = check.K_mm(x), check.M_mm(x)
        r = torch.linalg.norm(kx - float(lam) * mx) / (
            torch.linalg.norm(kx) + abs(float(lam)) * torch.linalg.norm(mx)
        )
        dev_res.append(r.item())
    check_counts = spmm.counts()

    exact = cavity_eigenvalues_3d(1.0, 1.0, 1.0, NEV)
    rel = np.abs(res.eigenvalues - exact) / exact
    # the refine's history restarts at iter 0 after the device iterations
    device_iters = next(
        (i for i, h in enumerate(res.history) if i and h["iter"] == 0),
        len(res.history),
    )
    log({
        "phase": "solve", "converged": res.converged,
        "iterations": res.iterations, "device_iterations": device_iters,
        "eigenvalues": [float(v) for v in res.eigenvalues],
        "analytic_rel_err": [float(v) for v in rel],
        "residuals_f64": [float(v) for v in res.residuals],
        "residuals_device_f32": dev_res,
        **res.timings, "wall_s": wall, "counts": counts,
        "residual_check_counts": check_counts,
    })
    if not res.converged or res.residuals.max() > 1e-8:
        raise AssertionError(f"not converged to 1e-8: {res.residuals}")
    if not np.all(np.isfinite(res.eigenvectors)):
        raise AssertionError("non-finite eigenvectors")
    if res.eigenvectors.shape != (problem.K.shape[0], NEV):
        raise AssertionError(f"eigenvector shape {res.eigenvectors.shape}")
    if not rel.max() <= 1e-2:
        raise AssertionError(f"eigenvalues off the analytic modes: {rel}")
    if not max(dev_res) <= DEVICE_RESIDUAL_TOL:
        raise AssertionError(f"device residual check: {dev_res}")
    for name in MAIN_PATH:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    for name in REPLACES:
        if counts[name + "_ref"] != 0 or check_counts[name + "_ref"] != 0:
            raise AssertionError(f"plain {name}_ref ran on the card")
    if check_counts["bellunion_matvec"] != 2 * NEV:
        raise AssertionError(f"residual check launches: {check_counts}")
    return counts, check_counts


def main():
    phase_device()
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    phase_build()
    problem = PermutedProblem(BrickCavity3D(nx=GRID, ny=GRID, nz=GRID))
    A, stats = phase_kernels(problem)
    counts, check_counts = phase_solve(problem, A)

    def entry(name):
        return {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": counts[name],
                "max_abs_err": stats[name]["max_abs_err"],
                "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}

    log({"off_main_path": [{
        **entry("bellunion_matvec"),
        "residual_check_launches": check_counts["bellunion_matvec"],
    }]})
    log({"kernels": [entry(name) for name in MAIN_PATH]})
    log(f"nvidia-smi: {nvidia_smi_line()}")
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
