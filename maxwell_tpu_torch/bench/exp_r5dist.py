"""The distributed device-resident solve -> refine chain on the card: the
port's counterpart of maxwell_tpu/bench/exp_r5dist.py (the reference's
`dist_time_to_1e8_64` row, run there on a mesh of one).

The grid^3 vacuum PEC brick as a slab-sharded tap stencil pencil
(DistStencilPencil3D, f32, `slabs` slabs on the one card) runs f32
lobpcg_dist with the distributed spectral preconditioner (precond
"spectral", alpha 15, nev 5, maxiter 40, tol 2e-6, stall_window 10) and
hands the stacked (global_rows, nev) block on the device
(return_device=True) to refine_dw_dist, whose double-word pair stays on
the device in the stacked layout. Recorded as in exp_r5chain (host clock,
synchronized): solve_cold_s, solve_steady_s (sorted), refine_dev_cold_s,
refine_dev_steady_s, refine_sweeps, and dist_time_to_1e8_device_resident_s
= median steady solve + median steady refine; then the refined pair
extracted to the global ordering, summed in f64 and verified by the plain
f64 tap stencil of the one-device pencil.

    python -m maxwell_tpu_torch.bench.exp_r5dist [--grid 64] [--slabs 1]
        [--steady 3] [--device cuda|cpu] [--out PATH]

--slabs 1 is the reference's mesh of one; 8 is the port's slab count for
config 5. Runs on the card unless --device cpu is given. Writes JSON to
--out (default build/maxwell_tpu_torch/probes/
exp_r5dist_<grid>_<slabs>_results.json), never to the reference's root
exp_r5dist_64_results.json.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from maxwell_tpu_torch.bench.exp_r5chain import ALPHA, NEV, TOL, accuracy, wall
from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write

SOLVE = dict(nev=NEV, maxiter=40, tol=2e-6, precond="spectral",
             precond_alpha=ALPHA, stall_window=10)


def run(grid: int = 64, slabs: int = 1, steady: int = 3,
        device="cuda") -> dict:
    """The distributed chain at grid^3 in `slabs` slabs: a cold run and
    `steady` steady runs of each stage. Returns the results."""
    from maxwell_tpu_torch.dist import make_mesh
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
    from maxwell_tpu_torch.solvers.dist_solve import host_vectors, lobpcg_dist
    from maxwell_tpu_torch.solvers.refine_device import refine_dw_dist

    dev = device_of(device)
    out = {"grid": grid, "slabs": slabs,
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu"}
    mesh = make_mesh(slabs, dev)
    dsp, out["setup_s"] = wall(lambda: DistStencilPencil3D.build(
        nx=grid, ny=grid, nz=grid, D=slabs, dtype=torch.float32,
        device=dev), dev)
    out["n_full"], out["global_rows"] = dsp.n_full, dsp.global_rows

    def solve():
        return lobpcg_dist(dsp, mesh, return_device=True, **SOLVE)

    def refine(X):
        return refine_dw_dist(dsp, mesh, X, tol=TOL, return_device=True)

    res, out["solve_cold_s"] = wall(solve, dev)
    runs = [wall(solve, dev) for _ in range(steady)]
    res = runs[-1][0]
    out["solve_steady_s"] = sorted(t for _, t in runs)
    out["solve_iters"] = int(res.iterations)
    out["solve_res"] = float(res.residuals.max())
    if not (torch.is_tensor(res.eigenvectors)
            and res.eigenvectors.device == dsp.device
            and res.eigenvectors.shape == (dsp.global_rows, NEV)):
        raise AssertionError("lobpcg_dist(return_device=True) left the "
                             "device")

    ref, out["refine_dev_cold_s"] = wall(lambda: refine(res.eigenvectors),
                                         dev)
    runs = [wall(lambda: refine(res.eigenvectors), dev)
            for _ in range(steady)]
    ref = runs[-1][0]
    out["refine_dev_steady_s"] = sorted(t for _, t in runs)
    out["refine_sweeps"] = int(ref.iterations)
    out["refine_res"] = float(ref.residuals.max())
    out["converged"] = bool(ref.converged)
    out["dist_time_to_1e8_device_resident_s"] = (
        statistics.median(out["solve_steady_s"])
        + statistics.median(out["refine_dev_steady_s"]))

    X64 = host_vectors(dsp, ref.eigenvectors)
    out.update(accuracy(grid, torch.from_numpy(X64).to(dev),
                        ref.eigenvalues))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--slabs", type=int, default=1)
    ap.add_argument("--steady", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    results = run(args.grid, args.slabs, args.steady, args.device)
    write(results, args.out or PROBE_DIR / (
        f"exp_r5dist_{args.grid}_{args.slabs}_results.json"))
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
