"""Shift-invert on the card: the port's counterpart of
maxwell_tpu/bench/exp_r5si.py, with the reference's keys.

Rows:
  - the grid2d^2 rectangle (128^2: n = 33,024 edges) on an f32 pencil
    ("union" on the card, "ref" on the CPU), sigma 45: the native LDL^T
    factor of K - sigma M on the host (ldlt_factor_2d128_s, _n), the
    shift-invert apply, two launches of the level-scheduled triangular
    solve (csrc/tri_solve.cu) between an M apply and the projector
    (si_apply_2d128_s), and the 40-step Lanczos solve, nev 4, tol 1e-6
    (si_solve_2d128_s, _res, _eigs);
  - the grid3d^3 stencil brick (64^3) at sigma 60 with the matrix-free
    MINRES backend (400 steps at most, tol 1e-11; every step a tap kernel
    apply): the apply (si_apply_64_stencil_s) and the 30-step solve, nev 3,
    tol 1e-5 (si_solve_64_stencil_s, si_solve_64_res, si_solve_64_eigs).

Each apply reads its residual on the host (the projector's CG, MINRES's
stopping test), so an apply is timed on the host clock: a chain of `chain`
applies, each fed the last one's output as the reference's fori_loop chain
(exp_r5si.py:46-55) feeds it, between two synchronizes
(bench/timing.wall_ms, median of 3), over `chain`. The key names keep the
reference's sizes; `grid2d` and `grid3d` say which ran. solves=False skips
the two solves (chip_smoke.py runs them in its shift-invert phases).

    python -m maxwell_tpu_torch.bench.exp_r5si [--grid2d 128] [--grid3d 64]
        [--no-solves] [--device cuda|cpu] [--out PATH]

Runs on the card unless --device cpu is given; there the applies are not
timed (their keys hold None: not measured) and the rest runs. Writes JSON
to --out (default build/maxwell_tpu_torch/probes/exp_r5si_results.json),
never to the reference's root exp_r5si_results.json.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from maxwell_tpu_torch.bench.exp_r5chain import wall
from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write

SIGMA_2D = 45.0  # config 3's shift
SIGMA_3D = 60.0  # near 6 pi^2, the 64^3 brick's triple mode
CHAIN_2D, CHAIN_3D = 4, 2  # applies a timed chain


def chain_s(ap, x, k: int, timed: bool):
    """Seconds of one apply from a chain of k applies (host clock, median
    of 3 chains); None where nothing is timed (the CPU)."""
    if not timed:
        return None
    from maxwell_tpu_torch.bench.timing import wall_ms

    def chain():
        y = x
        for _ in range(k):
            y = ap(y)
        return y

    return wall_ms(chain) / k / 1e3


def run(grid2d: int = 128, grid3d: int = 64, solves: bool = True,
        device="cuda") -> dict:
    """Both rows on `device`; the solves only with solves=True. Returns the
    results."""
    from maxwell_tpu_torch.problems import RectCavity2D
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
    from maxwell_tpu_torch.solvers.operator import Pencil
    from maxwell_tpu_torch.solvers.shift_invert import (
        build_shift_invert_op,
        shift_invert_lanczos,
    )

    dev = device_of(device)
    timed = dev.type == "cuda"
    out = {"device": torch.cuda.get_device_name(dev) if timed else "cpu",
           "grid2d": grid2d, "grid3d": grid3d}

    cav = RectCavity2D(nx=grid2d, ny=grid2d)
    KM = (cav.K, cav.M)
    pencil = Pencil.from_problem(cav, kernel="union" if timed else "ref",
                                 dtype=torch.float32, device=dev)
    apply_op, out["ldlt_factor_2d128_s"] = wall(
        lambda: build_shift_invert_op(pencil, SIGMA_2D, backend="ldlt",
                                      KM=KM), dev)
    out["ldlt_factor_2d128_n"] = int(cav.K.shape[0])
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((pencil.n_padded, 1), generator=gen, device=dev)
    out["si_apply_2d128_s"] = chain_s(apply_op, x, CHAIN_2D, timed)
    del apply_op
    if solves:
        r, out["si_solve_2d128_s"] = wall(lambda: shift_invert_lanczos(
            pencil, sigma=SIGMA_2D, nev=4, maxiter=40, tol=1e-6,
            backend="ldlt", KM=KM,
            generator=torch.Generator(dev).manual_seed(0)), dev)
        out["si_solve_2d128_res"] = float(r.residuals.max())
        out["si_solve_2d128_eigs"] = [float(v) for v in r.eigenvalues]
    del pencil

    stp = StencilPencil3D.build(nx=grid3d, ny=grid3d, nz=grid3d,
                                dtype=torch.float32, device=dev)
    si = build_shift_invert_op(stp, SIGMA_3D, backend="iterative")
    xs = torch.randn(stp.n_padded, generator=gen, device=dev) * stp.mask
    out["si_apply_64_stencil_s"] = chain_s(si, xs, CHAIN_3D, timed)
    if solves:
        rs, out["si_solve_64_stencil_s"] = wall(lambda: shift_invert_lanczos(
            stp, sigma=SIGMA_3D, nev=3, maxiter=30, tol=1e-5,
            backend="iterative",
            generator=torch.Generator(dev).manual_seed(0)), dev)
        out["si_solve_64_res"] = float(np.max(rs.residuals))
        out["si_solve_64_eigs"] = [float(v) for v in rs.eigenvalues]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid2d", type=int, default=128)
    ap.add_argument("--grid3d", type=int, default=64)
    ap.add_argument("--no-solves", dest="solves", action="store_false")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(PROBE_DIR / "exp_r5si_results.json"))
    args = ap.parse_args(argv)
    results = run(args.grid2d, args.grid3d, args.solves, args.device)
    write(results, args.out)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
