"""The device-resident solve -> refine chain on the card: the port's
counterpart of maxwell_tpu/bench/exp_r5chain.py, which defines the
reference's `time_to_1e8_64` row (bench.py:729-764).

At grid^3 (64^3: n = 811,200 edges) the vacuum PEC brick as an f32 tap
stencil pencil runs f32 LOBPCG with the spectral preconditioner (alpha 15,
nev 5, maxiter 60, tol 2e-6, stall_window 10) and hands its block, still
on the device in the padded layout (return_device=True), to the
double-word refinement `refine_dw`, which keeps its pair on the device
too; only (m,) eigenvalues and residuals reach the host. Recorded:

  solve_cold_s / solve_steady_s      the first LOBPCG and `steady` more
                                     (sorted; host clock, synchronized)
  refine_dev_cold_s / _steady_s      the same for refine_dw on the device
                                     block; refine_sweeps its iterations
  time_to_1e8_device_resident_s      median steady solve + median steady
                                     refine (the reference's definition)
  solve_host_steady_s, refine_host_steady_s, time_to_1e8_host_round_trip_s
                                     the host round trip beside it: the
                                     block copied to the host as an (n,
                                     nev) array, refined from there, f64
                                     vectors back on the host
  residuals_f64_verified             the refined pair summed in f64 on the
                                     device and applied by the plain f64
                                     tap stencil (outside every timed run)

With `trace_dir`, one extra steady solve runs under
maxwell_tpu_torch.utils.profiling.trace after the timed runs (the profiler
wraps no timed run); its Chrome trace goes into `trace_dir`, and its top 5
device kernels and device busy time are kept.

    python -m maxwell_tpu_torch.bench.exp_r5chain [--grid 64] [--steady 3]
        [--device cuda|cpu] [--trace DIR] [--out PATH]

Runs on the card unless --device cpu is given (there the same chain runs on
the CPU: its seconds are the CPU's, no device metric). Writes JSON to --out
(default build/maxwell_tpu_torch/probes/exp_r5chain_<grid>_results.json),
never to the reference's root exp_r5chain_*_results.json.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write

NEV = 5
SOLVE = dict(nev=NEV, maxiter=60, tol=2e-6, stall_window=10)
ALPHA = 15.0
TOL = 1e-8


def wall(fn, dev):
    """(fn(), host seconds), the device synchronized before and after."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def verified_residuals(grid: int, X64: torch.Tensor, theta) -> np.ndarray:
    """Relative residuals of (theta, X64) on the grid^3 vacuum PEC brick,
    applied in f64 by the plain tap stencil (uncounted) on X64's device.
    X64: (n, m) or (n_padded, m) f64 in the global stencil ordering."""
    from maxwell_tpu_torch.kernels.stencil_taps import taps_plain
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D

    p64 = StencilPencil3D.build(nx=grid, ny=grid, nz=grid,
                                dtype=torch.float64, device=X64.device)
    Xp = X64.new_zeros((p64.n_padded, X64.shape[1]))
    Xp[: p64.n] = X64[: p64.n]
    KX, MX = taps_plain(Xp, p64.mask, p64.taps, p64.shape, True, True)
    th = torch.as_tensor(np.asarray(theta, np.float64), device=X64.device)
    R = KX - MX * th[None, :]
    scale = KX.norm(dim=0) + th.abs() * MX.norm(dim=0)
    return (R.norm(dim=0) / scale).cpu().numpy()


def accuracy(grid: int, X64: torch.Tensor, theta) -> dict:
    """The gates of the reference's time_to_1e8 rows: the f64-verified
    residuals and the eigenvalues' distance to the analytic modes."""
    from maxwell_tpu_torch.problems.analytic import cavity_eigenvalues_3d

    theta = np.asarray(theta, np.float64)
    exact = cavity_eigenvalues_3d(1.0, 1.0, 1.0, len(theta))
    return {
        "eigenvalues": [float(v) for v in theta],
        "analytic_rel_err": [
            float(v) for v in np.abs(np.sort(theta) - exact) / exact],
        "residuals_f64_verified": [
            float(v) for v in verified_residuals(grid, X64, theta)],
    }


def run(grid: int = 64, steady: int = 3, host: bool = True,
        device="cuda", trace_dir=None) -> dict:
    """The chain at grid^3: a cold run and `steady` steady runs of each
    stage, then (host=True) one steady host round trip. Returns the
    results."""
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
    from maxwell_tpu_torch.solvers.lobpcg import lobpcg
    from maxwell_tpu_torch.solvers.refine_device import refine_dw
    from maxwell_tpu_torch.solvers.spectral import spectral_preconditioner

    dev = device_of(device)
    out = {"grid": grid,
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu"}

    def setup():
        p = StencilPencil3D.build(nx=grid, ny=grid, nz=grid,
                                  dtype=torch.float32, device=dev)
        return p, spectral_preconditioner(p, alpha=ALPHA)

    (stp, pc), out["setup_s"] = wall(setup, dev)
    out["n"] = stp.n

    def solve(return_device=True):
        return lobpcg(stp, precond=pc, return_device=return_device, **SOLVE)

    def refine(X, return_device=True):
        return refine_dw(stp, X, tol=TOL, return_device=return_device)

    res, out["solve_cold_s"] = wall(solve, dev)
    runs = [wall(solve, dev) for _ in range(steady)]
    res = runs[-1][0]
    out["solve_steady_s"] = sorted(t for _, t in runs)
    out["solve_iters"] = int(res.iterations)
    out["solve_res"] = float(res.residuals.max())
    if not (torch.is_tensor(res.eigenvectors)
            and res.eigenvectors.device == stp.device
            and res.eigenvectors.shape == (stp.n_padded, NEV)):
        raise AssertionError("lobpcg(return_device=True) left the device")

    ref, out["refine_dev_cold_s"] = wall(lambda: refine(res.eigenvectors),
                                         dev)
    runs = [wall(lambda: refine(res.eigenvectors), dev)
            for _ in range(steady)]
    ref = runs[-1][0]
    out["refine_dev_steady_s"] = sorted(t for _, t in runs)
    out["refine_sweeps"] = int(ref.iterations)
    out["refine_res"] = float(ref.residuals.max())
    out["converged"] = bool(ref.converged)
    out["time_to_1e8_device_resident_s"] = (
        statistics.median(out["solve_steady_s"])
        + statistics.median(out["refine_dev_steady_s"]))

    if host:
        res_h, out["solve_host_steady_s"] = wall(lambda: solve(False), dev)
        refh, out["refine_host_steady_s"] = wall(
            lambda: refine(res_h.eigenvectors, False), dev)
        out["refine_host_res"] = float(refh.residuals.max())
        out["time_to_1e8_host_round_trip_s"] = (
            out["solve_host_steady_s"] + out["refine_host_steady_s"])
        out["host_vs_device_eig_rel"] = float(np.max(
            np.abs(refh.eigenvalues - ref.eigenvalues)
            / np.abs(ref.eigenvalues)))

    Xh, Xl = ref.eigenvectors
    out.update(accuracy(grid, Xh.double() + Xl.double(), ref.eigenvalues))

    if trace_dir is not None:
        from maxwell_tpu_torch.utils.profiling import (
            device_busy_ms,
            top_kernels,
            trace,
        )

        with trace(trace_dir) as prof:
            solve()
        out["trace"] = prof.trace_path
        out["top_kernels"] = top_kernels(prof, 5)
        out["traced_solve_device_busy_ms"] = device_busy_ms(prof)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--steady", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trace", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    results = run(args.grid, args.steady, device=args.device,
                  trace_dir=args.trace)
    write(results, args.out or PROBE_DIR
          / f"exp_r5chain_{args.grid}_results.json")
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
