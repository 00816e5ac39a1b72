"""The shifted-CG preconditioner's strength at scale: the port's counterpart
of maxwell_tpu/bench/exp_conv.py, with the reference's keys.

kappa(K + alpha M) grows as 1/(alpha h^2), so a fixed CG sweep count loses
preconditioner quality as the grid refines. For each (alpha, CG sweeps)
combination, f32 LOBPCG (nev 5, tol 2e-6, `maxiter`) on the grid^3 vacuum
PEC brick as an f32 tap stencil pencil (every sweep one fused K/M tap
kernel launch), run twice from the same seeded start: the second run's
iterations, residual, whether it converged, the iterations to 1e-5 and to
2e-6 (-1: not reached), solve_s (its host seconds, synchronized), and
compile_s, the first run's extra seconds (the reference's XLA compile; here
the kernel build when it is the process's first launch, and the
allocator's warm-up).

    python -m maxwell_tpu_torch.bench.exp_conv [--grid 64] [--maxiter 120]
        [--device cuda|cpu] [--out PATH]

Runs on the card unless --device cpu is given (its seconds are then the
CPU's). Writes JSON to --out (default
build/maxwell_tpu_torch/probes/exp_conv_<grid>_results.json), never to a
file at the repository's root.
"""

from __future__ import annotations

import argparse
import json

import torch

from maxwell_tpu_torch.bench.exp_r5chain import wall
from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write

COMBOS = ((15.0, 16), (15.0, 32), (15.0, 48), (40.0, 32))


def first_below(hist, tol) -> int:
    return next((i for i, v in enumerate(hist) if v < tol), -1)


def run(grid: int = 64, maxiter: int = 120, combos=COMBOS,
        device="cuda") -> dict:
    """Every (alpha, sweeps) combination at grid^3. Returns
    {"g<grid>_a<alpha>_i<sweeps>": {...}, "device": name}."""
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
    from maxwell_tpu_torch.solvers.lobpcg import lobpcg
    from maxwell_tpu_torch.solvers.precond import shifted_cg_preconditioner

    dev = device_of(device)
    res = {"device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu"}
    stp = StencilPencil3D.build(nx=grid, ny=grid, nz=grid,
                                dtype=torch.float32, device=dev)
    for alpha, iters in combos:
        pc = shifted_cg_preconditioner(stp, alpha=alpha, iters=iters)

        def solve():
            return lobpcg(stp, nev=5, maxiter=maxiter, tol=2e-6, precond=pc)

        _, t_total = wall(solve, dev)
        r2, t_run = wall(solve, dev)
        hist = [h["max_rel_res"] for h in r2.history]
        res[f"g{grid}_a{alpha:g}_i{iters}"] = {
            "grid": grid, "alpha": alpha, "cg_iters": iters,
            "iterations": int(r2.iterations),
            "max_res": float(r2.residuals.max()),
            "converged": bool(r2.converged),
            "iters_to_1e5": first_below(hist, 1e-5),
            "iters_to_2e6": first_below(hist, 2e-6),
            "compile_s": t_total - t_run, "solve_s": t_run,
        }
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--maxiter", type=int, default=120)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    results = run(args.grid, args.maxiter, device=args.device)
    write(results, args.out or PROBE_DIR
          / f"exp_conv_{args.grid}_results.json")
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
