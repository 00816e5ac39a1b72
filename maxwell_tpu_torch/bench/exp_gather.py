"""K15e on the card: the X-gather probe of maxwell_tpu/bench/exp_gather.py.
It compares gather mechanisms at matched work: the slice size, a transposed
layout, and gathers of single elements from a tile staged in shared memory.

  g5_floor       no gather: each tile writes X[0:128] (K15d's e0 kernel)
  g0_slices      per tile the sum of its R S = 1,024 (8, 8) slices of X
                 (256 B each), summed in registers
  g1_slices2x    the sum of its R S / 2 (16, 8) slices (512 B each)
  g4_lane_ds     g1's slices from X^T: 8 rows of 16 floats (64 B each)
  g2_taa0        4,096 gathers g[p, j] = X[idx[p, j], j] from X[0:P]
                 staged per block; out g[0:8] + g[P-8:P]
  g3_taa1        4,096 gathers g[j, p] = X^T[j, idx[j, p]] from X^T[:, 0:P]
                 staged per block, written whole
  g3w_taa1_wide  g3 from the tile's own (8, 4096) source block, the
                 4,096 gathers the reference keeps, straight from global
                 memory (one warp per source row, nothing staged)

g0, g1 and g4 gather 256 KB of slices per tile (78.1 MB at T 298); g2, g3
and g3w 4,096 elements per tile.

    python -m maxwell_tpu_torch.bench.exp_gather [T] [S] [--device cuda|cpu]
        [--out PATH]

T tiles (default 298), S slots (default 64), R 16, b = m = 8, P = S b;
the inputs are the reference's (exp_gather.py:64-196), every array drawn
from numpy's default_rng(0) in its order. Per variant: ms (median of 20
launches), per_tile_ns (the reference's metric), plain_ms, gathered_GBps
(the gathered bytes over the time), bound_ms / bound_by at the card's
published rates (the inputs the variant reads by design once, and its
output once; for g3w the kept index columns and the distinct 32-byte
source sectors its kept gathers touch, counted from idx by
`touched_sectors`, with the old count of the whole source as
bytes_staged beside), library_ms of one PyTorch call computing the same
function (`library` says what it includes and excludes), for g0, g1 and g4
l2_floor_ms (their slices' bytes over the L2 read rate the run measures,
bench/timing.py l2_read_rate, l2_read_GBps: the byte bound lies under the
launch floor) and `launch` (gather_sum's plan: grid, the blocks'
slot counts, union sizes, bytes; registers and resident blocks), and the max
error against the plain version (the run fails above 1e-5 of max|plain|,
for the library call too, 1e-4 for embedding_bag's sums of up to 1,024
rows; g0, g1 and g4 also where a second run differs from the first,
`bitwise_repeat`).
Runs on the card unless --device cpu is given; there the plain versions
run and nothing is timed. Writes JSON to --out (default
build/maxwell_tpu_torch/probes/exp_gather_results.json); never the
reference's exp_gather_results.json.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write
from maxwell_tpu_torch.bench.timing import bound_ms, l2_read_rate, median_ms
from maxwell_tpu_torch.kernels import gather_probes as gpr
from maxwell_tpu_torch.utils.precision import fp32_true

TOL = 1e-5  # of max|plain|: f32 sums in another order than the plain's
# F.embedding_bag sums up to 1,024 f32 rows in an order of its own (on the
# card 1.0e-5 of max|plain| off on the 24^3 K, whose padding slots repeat
# one block): its sums are held to 1e-4 of max|plain|
LIB_TOL_SUM = 1e-4
T_REF, S_REF = 298, 64
W = 4096  # g3w's source width (exp_gather.py:190)
R, B, M = gpr.R, gpr.B, gpr.M
# gather_sum's variants: (rows of a slice, slots read: all or half, X^T)
SUMS = {"g0_slices": (B, 1, False), "g1_slices2x": (2 * B, 2, False),
        "g4_lane_ds": (2 * B, 2, True)}


def make_inputs(T: int, S: int, seed: int = 0) -> dict:
    """The reference's inputs (exp_gather.py:64-196), drawn in its order,
    including those a run does not use."""
    nbr = T * R
    n, P = nbr * B, S * B
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, nbr, size=(nbr, S), dtype=np.int32)
    X = rng.standard_normal((n, M)).astype(np.float32)
    idx0 = rng.integers(0, P, size=(T * P, M), dtype=np.int32)
    idx1 = rng.integers(0, P, size=(T * M, P), dtype=np.int32)
    idx1w = rng.integers(0, W, size=(T * M, W), dtype=np.int32)
    XTW = rng.standard_normal((T * M, W)).astype(np.float32)
    return dict(cols=cols, X=X, idx0=idx0, idx1=idx1, idx1w=idx1w, XTW=XTW)


def touched_sectors(idx: torch.Tensor, P: int) -> int:
    """The 32-byte sectors (8 f32) of each row's source that the row's
    first P indices touch, summed over the rows: per row the distinct
    idx // 8 among idx[:, :P] (a row of W floats starts on a sector)."""
    s = torch.sort(idx[:, :P].long() // 8, dim=1).values
    return int(s.shape[0] + (s[:, 1:] != s[:, :-1]).sum())


def window_view(X: torch.Tensor, rows: int) -> torch.Tensor:
    """(windows, rows m): X[8 c : 8 c + rows] flattened as row c, for every
    c whose window lies in X; a copy (the overlapping windows of
    X.as_strided, made contiguous)."""
    m = X.shape[1]
    nwin = X.shape[0] // B - rows // B + 1
    return X.as_strided((nwin, rows * m), (B * m, 1)).contiguous()


def bag_sum(cols, X, slots, rows):
    """One F.embedding_bag sum per tile over the windows view of X: the
    (rows, m) sum of the tile's R `slots` slices. Returns (call, as_plain):
    the call on operands formed beforehand, and the map of its (T, rows m)
    output to the plain version's (the sum tiled 128 / rows times)."""
    T, m = cols.shape[0] // R, X.shape[1]
    idx = cols[:, :slots].reshape(T, R * slots).long()
    Wv = window_view(X, rows)
    return (lambda: F.embedding_bag(idx, Wv, mode="sum"),
            lambda out: out.view(T, rows, m).repeat(
                1, R * B // rows, 1).reshape(-1, m))


def library(name, t, T, S):
    """(what, call, as_plain, tol) of one PyTorch call computing the
    variant's function: the call runs on operands formed beforehand;
    as_plain maps its output onto the plain version's (untimed); tol is
    the bound against the plain version, of max|plain|."""
    P = S * B
    if name == "g5_floor":
        X = t["X"]
        return ("X[:128].repeat(T, 1)", lambda: X[:R * B].repeat(T, 1),
                lambda out: out, TOL)
    if name == "g0_slices":
        call, as_plain = bag_sum(t["cols"], t["X"], S, B)
        return ("F.embedding_bag sum over X viewed as (nbr, 8 m) slices, "
                "one bag of R S per tile (excludes the R-fold tile)", call,
                as_plain, LIB_TOL_SUM)
    if name == "g1_slices2x":
        call, as_plain = bag_sum(t["cols"], t["Xp"], S // 2, 2 * B)
        return ("F.embedding_bag sum over the overlapping 16-row windows of "
                "the padded X, made contiguous beforehand, one bag of R S / "
                "2 per tile (excludes the 8-fold tile)", call, as_plain,
                LIB_TOL_SUM)
    if name == "g4_lane_ds":
        XTp, cols = t["XTp"], t["cols"]
        nbr = cols.shape[0]
        Wv = XTp.as_strided((nbr, M, 2 * B), (B, XTp.shape[1], 1)).reshape(
            nbr, M * 2 * B)
        idx = cols[:, :S // 2].reshape(T, R * S // 2).long()
        return ("F.embedding_bag sum over the (8, 16) column windows of the "
                "padded X^T, made contiguous beforehand, one bag of R S / 2 "
                "per tile (excludes the S-fold tile)",
                lambda: F.embedding_bag(idx, Wv, mode="sum"),
                lambda out: out.view(T, M, 2 * B).repeat(1, 1, S).reshape(
                    -1, 2 * B * S), LIB_TOL_SUM)
    if name == "g2_taa0":
        X, idx = t["X"][:P], t["idx0"].long()
        return ("torch.gather of all P m elements of X[0:P] (excludes the "
                "final two-row sum and the index widening)",
                lambda: torch.gather(X, 0, idx),
                lambda out: gpr.two_rows(out, P), TOL)
    if name == "g3_taa1":
        src = t["XT"][:, :P].expand(T, M, P)
        idx = t["idx1"].long().view(T, M, P)
        return ("torch.gather of all m P elements of X^T[:, 0:P], expanded "
                "over the tiles (excludes the index widening)",
                lambda: torch.gather(src, 2, idx),
                lambda out: out.reshape(-1, P), TOL)
    if name == "g3w_taa1_wide":
        src = t["XTW"].view(T, M, W)
        idx = t["idx1w"].long().view(T, M, W)[:, :, :P].contiguous()
        return ("torch.gather of the first P index columns from each tile's "
                "(8, 4096) block (excludes the index slice and widening)",
                lambda: torch.gather(src, 2, idx),
                lambda out: out.reshape(-1, P), TOL)
    raise KeyError(name)


def sum_launch(cols, m, rows, slots, transposed) -> dict:
    """gather_sum's launch on the card for these cols: the plan's summary
    (gpr.GatherPlan.summary) and the kernel's registers, local memory and
    resident blocks per SM."""
    sms = torch.cuda.get_device_properties(cols.device).multi_processor_count
    plan = gpr.gather_plan(cols, m, sms, rows, slots, transposed)
    return {**plan.summary(cols), **gpr.launch_shape(plan)}


@fp32_true
def run(T: int = T_REF, S: int = S_REF, device="cuda") -> dict:
    """Every variant at T tiles of S slots on `device`; raises if a kernel
    or a library call disagrees with the plain version. Returns the
    results."""
    dev = device_of(device)
    if S % 2 or S < 2:
        raise ValueError(f"S = {S} must be even (g1/g4 read S / 2 slots)")
    t = {k: torch.from_numpy(v).to(dev)
         for k, v in make_inputs(T, S).items()}
    X = t["X"]
    t["Xp"] = F.pad(X, (0, 0, 0, B))  # exp_gather.py:135
    t["XT"] = X.T.contiguous()  # :68
    t["XTp"] = F.pad(t["XT"], (0, B))  # :239
    timed = dev.type == "cuda"
    nbr = T * R
    n, P = nbr * B, S * B
    f4 = 4  # bytes of an f32 or int32
    slices = T * R * S * B * M * f4  # g0, g1, g4: 256 KB per tile at S 64
    elems = T * P * M * f4  # g2, g3, g3w: 4,096 elements per tile at S 64
    results = {
        "device": torch.cuda.get_device_name(dev) if timed else "cpu",
        "T": T, "S": S, "R": R, "b": B, "m": M, "P": P, "W": W, "n": n,
        "slice_bytes": slices, "element_bytes": elems,
        "bound": "bytes of the inputs the variant reads by design once "
                 "(cols it reads, X or X[0:P] or the staged source, idx "
                 "it reads; g3w: the source's 32-byte sectors its kept "
                 "gathers touch) and of its output once, at 3.35 TB/s",
    }
    if timed:  # the slices of g0, g1, g4 come from L2: their floor
        results["l2_read_GBps"] = l2_read_rate(dev) / 1e9
    y128 = T * R * B * M * f4
    half_cols = nbr * (S // 2) * f4
    # name: (kernel, args, bytes, additions, gathered bytes)
    variants = {
        "g5_floor": (gpr.g5_floor, (X, T), R * B * M * f4 + y128, 0, y128),
        "g0_slices": (gpr.g0_slices, (t["cols"], X),
                      nbr * S * f4 + n * M * f4 + y128, slices // f4, slices),
        "g1_slices2x": (gpr.g1_slices2x, (t["cols"], t["Xp"]),
                        half_cols + (n + B) * M * f4 + y128, slices // f4,
                        slices),
        "g4_lane_ds": (gpr.g4_lane_ds, (t["cols"], t["XTp"]),
                       half_cols + (n + B) * M * f4 + T * M * 2 * B * S * f4,
                       slices // f4, slices),
        "g2_taa0": (gpr.g2_taa0, (t["idx0"], X, P),
                    elems + P * M * f4 + T * B * M * f4, T * B * M, elems),
        "g3_taa1": (gpr.g3_taa1, (t["idx1"], t["XT"]),
                    elems + M * P * f4 + elems, 0, elems),
        "g3w_taa1_wide": (gpr.g3w_taa1_wide, (t["idx1w"], t["XTW"], P),
                          elems + 32 * touched_sectors(t["idx1w"], P)
                          + elems, 0, elems),
    }
    for name, (kern, args, nbytes, adds, gathered) in variants.items():
        plain = gpr.PLAIN_OF[kern]
        got, want = kern(*args), plain(*args)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if got.shape != want.shape or not err <= TOL * scale:
            raise AssertionError(f"{name}: max error {err:.3e} > {TOL} * "
                                 f"{scale:.3e} against the plain version")
        what, call, as_plain, tol = library(name, t, T, S)
        lib_err = (as_plain(call()) - want).abs().max().item()
        if not lib_err <= tol * scale:
            raise AssertionError(f"{name}: library call off by {lib_err:.3e}"
                                 f" > {tol} * {scale:.3e}")
        row = {"max_abs_err": err, "rel_err": err / scale,
               "library": what, "library_max_abs_err": lib_err}
        if name in SUMS:  # fixed summation order: runs repeat bit for bit
            row["bitwise_repeat"] = torch.equal(got, kern(*args))
            if not row["bitwise_repeat"]:
                raise AssertionError(f"{name}: two runs differ")
        if timed:
            ms = median_ms(lambda: kern(*args))
            b_ms, b_by = bound_ms(nbytes, adds, "f32")
            row.update(ms=ms, per_tile_ns=ms * 1e6 / T,
                       plain_ms=median_ms(lambda: plain(*args)),
                       bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                       gathered_bytes=gathered,
                       gathered_GBps=gathered / ms / 1e6,
                       library_ms=median_ms(call))
            if name == "g3w_taa1_wide":  # staging each tile's source
                row["bytes_staged"] = elems + t["XTW"].numel() * f4 + elems
            if name in SUMS:
                rows, half, xt = SUMS[name]
                row["l2_floor_ms"] = gathered / (
                    results["l2_read_GBps"] * 1e9) * 1e3
                row["launch"] = sum_launch(t["cols"], M, rows, S // half, xt)
        results[name] = row
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("T", nargs="?", type=int, default=T_REF)
    ap.add_argument("S", nargs="?", type=int, default=S_REF)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out",
                    default=str(PROBE_DIR / "exp_gather_results.json"))
    args = ap.parse_args(argv)
    results = run(args.T, args.S, args.device)
    write(results, args.out)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
