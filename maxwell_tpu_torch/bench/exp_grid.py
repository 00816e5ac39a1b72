"""K15d on the card: the BELLPairs per-tile cost probe of
maxwell_tpu/bench/exp_grid.py. It splits K11's cost per 128-row tile into
per-block and per-step overhead, gathering X slices in registers or staged
per row, and the full pair-panel product:

  e0_grid1       one block per tile, each writing X[0:128]
  e1_grid6       six blocks per tile, five doing nothing
  e2_grid6_when  one block per tile, six chunk steps that stop at the
                 tile's live count (3)
  e3_acc424      the tile's 16 x 24 pair slices of X summed in registers
                 (gather_sum's even split of the slots)
  e4_cat424      the same slices staged per block row, then summed (rows
                 spread evenly over the SMs, cp.async rings)
  e5_cat424_mm   the full product: per block row the 24 live (8, 16)
                 value panels @ their X slices (K11's arithmetic; value
                 boxes by bulk copies, slices by cp.async, into rings)

    python -m maxwell_tpu_torch.bench.exp_grid [T] [--device cuda|cpu]
        [--out PATH]

T tiles (default 298), R 16, b = m = 8, NCH 6 chunks of Cp 8 pair slots, 3
live; the inputs are the reference's (exp_grid.py:32-44), drawn from
numpy's default_rng(0) in its order. Per variant: ms (median of 20
launches), per_tile_ns, plain_ms, bound_ms / bound_by at the card's
published rates (the bytes the function needs: X's 4 KB block or X once,
the used cols, for e5 the live half of the value stream, Y once),
gathered_GBps (the X slice bytes, with e5's value panels, over the time),
library_ms of one PyTorch call computing the same function (X[:128].repeat
for e0/e1, a broadcast torch.mul for e2, F.embedding_bag sums over X's
overlapping 16-row windows for e3/e4, one torch.bmm on the panel gathered
beforehand for e5; `library` says what each includes and excludes), and
the max error against the plain version (the run fails above 1e-5 of
max|plain|, the library call's too, at 1e-4 for the embedding_bag sums).
e3-e5 also record bitwise_repeat (a second launch equal bit for bit, or
the run fails), launch (their plan's summary with registers, local memory
and resident blocks per SM) and l2_floor_ms (their slices' bytes over the
L2 read rate this run measures, bench/timing.py l2_read_rate; l2_read_GBps
at the top).
Then, at the reference's T 298 only, K11
(bellpairs_matmat) at m 8 on the 24^3 RCM brick's K, timed beside e5: its
4,768 block rows of 48 pair slots are the probe's 298 tiles, so at another
T the comparison has no counterpart and is left out.
Runs on the card unless --device cpu is given; there the plain versions
run and nothing is timed. Writes JSON to --out (default
build/maxwell_tpu_torch/probes/exp_grid_results.json).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from maxwell_tpu_torch.bench.exp_gather import (
    LIB_TOL_SUM,
    bag_sum,
    window_view,
)
from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write
from maxwell_tpu_torch.bench.timing import bound_ms, l2_read_rate, median_ms
from maxwell_tpu_torch.kernels import gather_probes as gpr
from maxwell_tpu_torch.kernels import grid_probes as gp
from maxwell_tpu_torch.utils.precision import fp32_true

TOL = 1e-5  # of max|plain|: f32 sums in another order than the plain's
LIVE = 3  # live chunks per tile (the 24^3 matrix has ~3.3)
T_REF = 298  # the reference's tiles: the block rows of K11_GRID^3's K
K11_GRID = 24
# the gathering variants, by their launch's kind
GATHERS = {"e3_acc424": "sum", "e4_cat424": "cat", "e5_cat424_mm": "cat_mm"}


def make_inputs(T: int, seed: int = 0) -> dict:
    """The reference's inputs (exp_grid.py:32-44), drawn in its order."""
    nbr = T * gp.R
    n = nbr * gp.B
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, nbr - 1, size=(nbr, gp.NCH * gp.CP),
                        dtype=np.int32)
    nch = np.full((T,), LIVE, np.int32)
    X = rng.standard_normal((n + gp.B, gp.M)).astype(np.float32)
    vals = rng.standard_normal(
        (n, gp.NCH * gp.CP * 2 * gp.B)).astype(np.float32)
    return dict(cols=cols, nch=nch, X=X, vals=vals)


def _k11(grid: int, dev: torch.device, timed: bool, e5_ms) -> dict:
    """K11 at m 8 on the grid^3 RCM brick's K: against its plain arithmetic
    (uncounted), timed, with the live pair bytes' rate."""
    from maxwell_tpu_torch.kernels import bellpairs_spmm as kp
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.bellpairs import BELLPairs
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    K = PermutedProblem(BrickCavity3D(nx=grid, ny=grid, nz=grid)).K.tocsr()
    A = BELLPairs.from_csr(K, device=dev)
    n = K.shape[0]
    Xh = np.zeros((A.n_padded, gp.M), np.float32)
    Xh[:n] = np.random.default_rng(5).standard_normal((n, gp.M))
    X = torch.from_numpy(Xh).to(dev)
    got = kp.bellpairs_matmat(A, X, "a")
    want = kp._pairs(A, X, "a")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not err <= TOL * scale:
        raise AssertionError(f"K11: max error {err:.3e} > {TOL} * "
                             f"{scale:.3e} against the plain version")
    live = int(A.npairs.sum())
    row = {"grid": grid, "n": n, "block_rows": A.n_brows,
           "slots": int(A.cols.shape[1]), "live_pairs": live,
           "mean_live_pairs_per_block_row": live / A.n_brows,
           "live_pair_bytes": live * 2 * A.b * A.b * 4,
           "max_abs_err": err}
    if timed:
        ms = median_ms(lambda: kp.bellpairs_matmat(A, X, "a"))
        row.update(ms=ms, live_pair_GBps=row["live_pair_bytes"] / ms / 1e6,
                   e5_over_k11=e5_ms / ms)
    return row


@fp32_true
def run(T: int = T_REF, device="cuda") -> dict:
    """Every variant at T tiles on `device`, then (at T_REF) K11 on the
    K11_GRID^3 K; raises if a kernel disagrees with its plain version.
    Returns the results."""
    dev = device_of(device)
    data = make_inputs(T)
    t = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    cols, nch, X, vals = (t[k] for k in ("cols", "nch", "X", "vals"))
    timed = dev.type == "cuda"
    nbr, Q = cols.shape
    slots = LIVE * gp.CP  # live pair slots per block row
    y_bytes = gp.TILE * T * gp.M * 4
    block = gp.TILE * gp.M * 4  # X[0:128]
    used_cols = nbr * slots * 4
    slice_bytes = nbr * slots * 2 * gp.B * gp.M * 4  # the gathered slices
    live_vals = nbr * gp.B * slots * 2 * gp.B * 4  # e5's live panels
    results = {
        "device": torch.cuda.get_device_name(dev) if timed else "cpu",
        "T": T, "R": gp.R, "b": gp.B, "m": gp.M, "NCH": gp.NCH,
        "Cp": gp.CP, "LIVE": LIVE, "nbr": nbr, "n": nbr * gp.B,
        "slice_bytes": slice_bytes, "live_value_bytes": live_vals,
    }
    if timed:  # the slices of e3-e5 come from L2: their floor
        results["l2_read_GBps"] = l2_read_rate(dev) / 1e9
    # name: (kernel, plain args, bytes, flops, gathered bytes)
    variants = {
        "e0_grid1": (gp.e0_grid1, (X, T), block + y_bytes, 0, T * block),
        "e1_grid6": (gp.e1_grid6, (X, T), block + y_bytes, 0, T * block),
        "e2_grid6_when": (gp.e2_grid6_when, (nch, X),
                          block + T * 4 + y_bytes,
                          LIVE * gp.TILE * T * gp.M, T * block),
        "e3_acc424": (gp.e3_acc424, (cols, X, LIVE),
                      used_cols + X.numel() * 4 + y_bytes,
                      slice_bytes // 4, slice_bytes),
        "e4_cat424": (gp.e4_cat424, (cols, X, LIVE),
                      used_cols + X.numel() * 4 + y_bytes,
                      slice_bytes // 4, slice_bytes),
        "e5_cat424_mm": (gp.e5_cat424_mm, (cols, vals, X, LIVE),
                         live_vals + used_cols + X.numel() * 4 + y_bytes,
                         2 * live_vals // 4 * gp.M,
                         slice_bytes + live_vals),
    }
    for name, (kern, args, nbytes, flops, gathered) in variants.items():
        plain = gp.PLAIN_OF[kern]
        got, want = kern(*args), plain(*args)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if got.shape != want.shape or not err <= TOL * scale:
            raise AssertionError(f"{name}: max error {err:.3e} > {TOL} * "
                                 f"{scale:.3e} against the plain version")
        what, call, as_plain, tol = library(name, t, T)
        lib_err = (as_plain(call()) - want).abs().max().item()
        if not lib_err <= tol * scale:
            raise AssertionError(f"{name}: library call off by {lib_err:.3e}"
                                 f" > {tol} * {scale:.3e}")
        row = {"max_abs_err": err, "rel_err": err / scale, "library": what,
               "library_max_abs_err": lib_err}
        if name in GATHERS:  # fixed summation order: runs repeat bit for bit
            row["bitwise_repeat"] = torch.equal(got, kern(*args))
            if not row["bitwise_repeat"]:
                raise AssertionError(f"{name}: two runs differ")
        if timed:
            ms = median_ms(lambda: kern(*args))
            b_ms, b_by = bound_ms(nbytes, flops, "f32")
            row.update(ms=ms, per_tile_ns=ms * 1e6 / T,
                       plain_ms=median_ms(lambda: plain(*args)),
                       bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                       flops=flops, gathered_bytes=gathered,
                       gathered_GBps=gathered / ms / 1e6,
                       library_ms=median_ms(call))
            if name in GATHERS:
                row["l2_floor_ms"] = slice_bytes / (
                    results["l2_read_GBps"] * 1e9) * 1e3
                row["launch"] = launch(name, cols)
        results[name] = row
    if T == T_REF:
        results["k11"] = _k11(K11_GRID, dev, timed,
                              results["e5_cat424_mm"].get("ms"))
    return results


def launch(name, cols) -> dict:
    """The variant's launch on the card for these cols at LIVE: its plan's
    summary and the kernel's registers, local memory and resident blocks
    per SM (e3: gather_sum's plan, e4/e5: the row plan)."""
    sms = torch.cuda.get_device_properties(cols.device).multi_processor_count
    if name == "e3_acc424":
        plan = gp.acc_plan(cols, LIVE, sms)
        return {**plan.summary(cols), **gpr.launch_shape(plan)}
    plan = gp.row_plan(cols.shape[0], LIVE, sms, GATHERS[name])
    return {**plan.summary(), **gp.rows_shape(plan)}


def library(name, t, T):
    """(what, call, as_plain, tol) of one PyTorch call computing the
    variant's function: the call runs on operands formed beforehand (t:
    the run's tensors); as_plain maps its output onto the plain version's
    (untimed); tol is the bound against the plain version, of
    max|plain|."""
    X, cols = t["X"], t["cols"]
    slots = LIVE * gp.CP
    if name in ("e0_grid1", "e1_grid6"):
        return ("X[:128].repeat(T, 1)", lambda: X[:gp.TILE].repeat(T, 1),
                lambda out: out, TOL)
    if name == "e2_grid6_when":
        base = X[:gp.TILE]
        fac = (1 + t["nch"].clamp(0, gp.NCH)).float()[:, None, None]
        return ("torch.mul of X[:128] by each tile's factor 1 + min(nch, 6)"
                ", broadcast (excludes forming the factor)",
                lambda: torch.mul(base, fac),
                lambda out: out.reshape(-1, gp.M), TOL)
    if name == "e3_acc424":
        call, as_plain = bag_sum(cols, X, slots, 2 * gp.B)
        return ("F.embedding_bag sum over the overlapping 16-row windows "
                "X.as_strided((nbr, 128), (64, 1)), made contiguous "
                "beforehand, one bag of the tile's 16 x 24 live slots "
                "(excludes the 8-fold tile)", call, as_plain, LIB_TOL_SUM)
    if name == "e4_cat424":
        nbr, Q = cols.shape
        idx = cols.view(T, gp.R, Q)[:, :gp.R // 2, :slots].reshape(
            -1, slots).long()
        Wv = window_view(X, 2 * gp.B)
        return ("F.embedding_bag sum over the same windows, one bag of 24 "
                "live slots per block row r < 8 of each tile (excludes the "
                "column slice, taken beforehand)",
                lambda: F.embedding_bag(idx, Wv, mode="sum"),
                lambda out: out.reshape(-1, gp.M), LIB_TOL_SUM)
    if name == "e5_cat424_mm":
        nbr, Q = cols.shape
        k = slots * 2 * gp.B
        V = t["vals"].view(nbr, gp.B, Q * 2 * gp.B)[:, :, :k]  # live half
        P = gp.slices(cols, X, slots).reshape(nbr, k, gp.M)
        return ("torch.bmm on the panel gathered beforehand (excludes the "
                "gather)", lambda: torch.bmm(V, P),
                lambda out: out.reshape(-1, gp.M), TOL)
    raise KeyError(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("T", nargs="?", type=int, default=T_REF)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(PROBE_DIR / "exp_grid_results.json"))
    args = ap.parse_args(argv)
    results = run(args.T, args.device)
    write(results, args.out)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
