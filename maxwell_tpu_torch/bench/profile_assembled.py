"""Where the time of the assembled f32 LOBPCG goes on the card, per layout:
the 24^3 RCM brick (n = 38,088) as a "union", "pallas" and "bellpairs"
pencil, and in 8 row shards (dist/partition.py) as a union pencil with the
fused interior SpMM + halo copy ("union/rdma_overlap") and a blocked-ELL
pencil with the ring shift ("pallas/rdma"), with solve()'s shifted-CG
preconditioner (20 sweeps, alpha the smallest analytic eigenvalue). For
each: 10 iterations after a warm-up, timed on the host clock and traced
with torch.profiler (device time by kernel), then the solve to 1e-5 from a
seeded block (the chip smoke's knobs), twice: nothing on these roads adds
in a varying order, so the two runs must agree bit for bit
(`repeat_identical`). One JSON line per case.

    python -m maxwell_tpu_torch.bench.profile_assembled [case ...]

Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from maxwell_tpu_torch.dist import partition_problem
from maxwell_tpu_torch.problems import BrickCavity3D
from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist
from maxwell_tpu_torch.solvers.lobpcg import lobpcg
from maxwell_tpu_torch.solvers.operator import Pencil
from maxwell_tpu_torch.solvers.precond import shifted_cg_preconditioner
from maxwell_tpu_torch.sparse.reorder import PermutedProblem
from maxwell_tpu_torch.utils.precision import fp32_true

GRID = 24
SHARDS = 8
CASES = ("union", "pallas", "bellpairs", "union/rdma_overlap", "pallas/rdma")


def _profile(fn):
    """(host ms, device busy ms, device ops, top rows) of one run of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return wall_ms, busy, sum(e.count for e in dev), [
        (e.key[:60], e.self_device_time_total / 1e3, e.count) for e in top
    ]


@fp32_true
def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    problem = PermutedProblem(BrickCavity3D(nx=GRID, ny=GRID, nz=GRID))
    alpha = float(problem.analytic_eigenvalues(1)[0])
    n = problem.K.shape[0]
    X0 = np.random.default_rng(5).standard_normal((n, 9))
    for case in sys.argv[1:] or CASES:
        kernel, _, halo_impl = case.partition("/")
        if halo_impl:
            pencil = partition_problem(
                problem, SHARDS, kernel=kernel, dtype=torch.float32,
                reorder=False, halo_impl=halo_impl, device="cuda")
            run = lambda it, tol, **kw: lobpcg_dist(  # noqa: E731
                pencil, nev=5, maxiter=it, tol=tol, precond_alpha=alpha,
                X0=X0, **kw)
        else:
            pencil = Pencil.from_problem(problem, kernel=kernel,
                                         dtype=torch.float32, device="cuda")
            pc = shifted_cg_preconditioner(pencil, alpha=alpha, iters=20)
            run = lambda it, tol, **kw: lobpcg(  # noqa: E731
                pencil, nev=5, maxiter=it, tol=tol, precond=pc, X0=X0, **kw)
        run(3, 1e-30)  # warm-up
        wall_ms, busy_ms, ops, top = _profile(lambda: run(10, 1e-30))
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(120, 1e-5, stall_window=12)
            torch.cuda.synchronize()
            runs.append((res, time.perf_counter() - t0))
        (res, solve_s), (res2, _) = runs
        hist = [h["max_rel_res"] for h in res.history]
        identical = (hist == [h["max_rel_res"] for h in res2.history]
                     and np.array_equal(res.eigenvectors, res2.eigenvectors))
        print(json.dumps({
            "case": case, "grid": GRID, "n": n, "card": card,
            "shards": SHARDS if halo_impl else 1,
            "iterations_profiled": 10, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_ops": ops,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "top_device_ms": top, "solve_iterations": res.iterations,
            "solve_s": solve_s,
            "solve_max_res": float(res.residuals.max()),
            "history_max_res": hist, "repeat_identical": identical,
        }), flush=True)
        del pencil, run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
