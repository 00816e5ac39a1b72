"""Double-word exactness and the refinement's costs on the card: the port's
counterpart of maxwell_tpu/bench/exp_r4chip.py, with the reference's keys.

  1. two_prod_err: the error-free product (utils/twofloat.two_prod) on the
     device for the five broadcast shapes of the reference (same shape, a
     0-d scalar, a row, a column, an outer product), |p + e - x y| in f64
     (0 when exact); dw_sum_err: the double-word sum of 10^6 values against
     the f64 sum.
  2. bw_GBps: the copy rate (bench/timing.copy_bandwidth); union_prod: K2
     (csrc/bellunion_spmm.cu, the one-stream union SpMM) on the K of the
     union_grid^3 RCM brick at m 8: time_s (median of 20 launches), err
     against scipy in f64, pct (the live bytes it reads and writes over
     the copy rate, as a share of its time), nnz_per_s, and bound_ms /
     bound_by at the card's published rates.
  3. At stencil_grid^3 (64^3), m 5: the double-word fused K/M tap apply
     (KM_mm_dw, eager elementwise ops) and the spectral shift solve
     SpectralShiftSolver.solve_sigma at per-column shifts, each on the host
     clock (bench/timing.wall_ms, median of 3: the dw apply copies its tap
     table from the host on every call, a copy that waits for the device,
     so device_ms's sleep cannot hold it back) and by its device busy
     time in one traced call (`*_device_s`, utils/profiling); the dw
     apply's first call's host seconds as dw_apply_64_compile_s; the f32 K
     apply (one tap kernel launch, median_ms); dw_apply_rel_err holds the
     double-word apply to an f64 apply.

    python -m maxwell_tpu_torch.bench.exp_r4chip [--union-grid 24]
        [--stencil-grid 64] [--device cuda|cpu] [--out PATH]

Runs on the card unless --device cpu is given; there nothing is timed (the
time keys hold None: not measured) and the checks run. Writes JSON to
--out (default build/maxwell_tpu_torch/probes/exp_r4chip_results.json),
never to the reference's root exp_r4chip_results.json.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from maxwell_tpu_torch.bench.exp_r5chain import wall
from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write

M_UNION, M_DW = 8, 5


def exactness(dev, rng) -> dict:
    """Part 1 on `dev`."""
    from maxwell_tpu_torch.utils import twofloat as tf

    n, m = 4096, 8
    A = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32))
    A, B = A.to(dev), B.to(dev)
    checks = {}
    for label, x, y in (
        ("same_shape", A, B),
        ("scalar", torch.tensor(1.7320508, dtype=torch.float32, device=dev),
         B),
        ("row_major_bcast", A[:1], B),  # (1, m) * (n, m)
        ("col_minor_bcast", A[:, :1], B),  # (n, 1) * (n, m)
        ("outer", A[:, :1], B[:1]),  # (n, 1) * (1, m)
    ):
        p, e = tf.two_prod(x, y)
        ref = x.double() * y.double()
        checks[label] = float((p.double() + e.double() - ref).abs().max())
    x64 = rng.standard_normal(1_000_000)
    xh, xl = tf.dw_from_f64(x64)
    sh, sl = tf.dw_sum(torch.from_numpy(xh).to(dev),
                       torch.from_numpy(xl).to(dev))
    return {"two_prod_err": checks,
            "dw_sum_err": float(abs(tf.dw_to_f64(sh, sl)
                                    - tf.dw_to_f64(xh, xl).sum()))}


def union_prod(grid: int, dev, timed: bool, rng) -> dict:
    """Part 2: bw_GBps and union_prod."""
    from maxwell_tpu_torch.bench.timing import (
        bound_ms,
        copy_bandwidth,
        median_ms,
        union_bytes,
    )
    from maxwell_tpu_torch.kernels.spmm import bellunion_matmat
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.bellunion import BELLUnion
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    K = PermutedProblem(BrickCavity3D(nx=grid, ny=grid, nz=grid)).K.tocsr()
    AU = BELLUnion.from_csr(K, block=8, dtype=torch.float32, device=dev)
    X = torch.from_numpy(rng.standard_normal(
        (AU.n_cols_padded, M_UNION)).astype(np.float32)).to(dev)
    Y = bellunion_matmat(AU, X)[: K.shape[0]].cpu().numpy()
    want = K @ X[: K.shape[1]].cpu().double().numpy()
    row = {"err": float(np.abs(Y - want).max() / np.abs(want).max()),
           "m": M_UNION, "nnz": int(K.nnz)}
    out = {"bw_GBps": None, "union_prod": row}
    if timed:
        bw = copy_bandwidth(dev)
        t = median_ms(lambda: bellunion_matmat(AU, X)) * 1e-3
        live, _ = union_bytes(AU, 1, M_UNION)
        b_ms, b_by = bound_ms(live, 2 * K.nnz * M_UNION, "f32")
        out["bw_GBps"] = bw / 1e9
        row.update(time_s=t, pct=100 * live / bw / t,
                   nnz_per_s=int(K.nnz / t), bytes=live, bound_ms=b_ms,
                   bound_by=b_by, pct_bound=100 * b_ms / (t * 1e3))
    else:
        row.update(time_s=None, pct=None, nnz_per_s=None)
    return out


def dw_costs(grid: int, dev, timed: bool, rng) -> dict:
    """Part 3."""
    from maxwell_tpu_torch.bench.timing import median_ms, wall_ms
    from maxwell_tpu_torch.kernels.stencil_taps import taps_plain
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
    from maxwell_tpu_torch.solvers.spectral import SpectralShiftSolver
    from maxwell_tpu_torch.utils import twofloat as tf

    stp = StencilPencil3D.build(nx=grid, ny=grid, nz=grid,
                                dtype=torch.float32, device=dev)
    Xh = torch.from_numpy(rng.standard_normal(
        (stp.n_padded, M_DW)).astype(np.float32)).to(dev)
    Xl = torch.zeros_like(Xh)
    ((KXh, KXl), _), cold = wall(lambda: stp.KM_mm_dw(Xh, Xl), dev)
    p64 = StencilPencil3D.build(nx=grid, ny=grid, nz=grid,
                                dtype=torch.float64, device=dev)
    K64, _ = taps_plain(Xh.double(), p64.mask, p64.taps, p64.shape, True,
                        False)
    got = KXh.double() + KXl.double()
    out = {"dw_apply_rel_err": float((got - K64).abs().max()
                                     / K64.abs().max()),
           "dw_apply_64_compile_s": cold, "dw_apply_64_s": None,
           "f32_apply_64_s": None, "spectral_sigma_64_s": None,
           "stencil_grid": grid, "m": M_DW}
    sol = SpectralShiftSolver.build(
        1.0, 1.0, 1.0, grid, grid, grid, alpha=0.0, n_padded=stp.n_padded,
        dtype=torch.float32, device=dev)
    sig = torch.from_numpy(rng.uniform(20.0, 30.0, M_DW).astype(
        np.float32)).to(dev)
    W = sol.solve_sigma(Xh, sig)
    out["spectral_sigma_finite"] = bool(torch.isfinite(W).all())
    if timed:
        from maxwell_tpu_torch.utils.profiling import device_busy_ms, trace

        for key, fn in (("dw_apply_64", lambda: stp.KM_mm_dw(Xh, Xl)),
                        ("spectral_sigma_64",
                         lambda: sol.solve_sigma(Xh, sig))):
            out[f"{key}_s"] = wall_ms(fn) / 1e3
            with trace(None) as prof:
                fn()
            out[f"{key}_device_s"] = device_busy_ms(prof) / 1e3
        out["f32_apply_64_s"] = median_ms(lambda: stp.K_mm(Xh)) / 1e3
    return out


def run(union_grid: int = 24, stencil_grid: int = 64, device="cuda") -> dict:
    """The three parts on `device`. Returns the results."""
    dev = device_of(device)
    timed = dev.type == "cuda"
    rng = np.random.default_rng(7)
    results = {"device": torch.cuda.get_device_name(dev) if timed else "cpu",
               "union_grid": union_grid}
    results.update(exactness(dev, rng))
    results.update(union_prod(union_grid, dev, timed, rng))
    results.update(dw_costs(stencil_grid, dev, timed, rng))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--union-grid", type=int, default=24)
    ap.add_argument("--stencil-grid", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out",
                    default=str(PROBE_DIR / "exp_r4chip_results.json"))
    args = ap.parse_args(argv)
    results = run(args.union_grid, args.stencil_grid, args.device)
    write(results, args.out)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
