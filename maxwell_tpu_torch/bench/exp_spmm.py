"""K15c on the card: the blocked-ELL SpMM probe of
maxwell_tpu/bench/exp_spmm.py on the RCM brick's K (24^3: n = 38,088, 4,768
block rows of S = 64 slots, a 78.1 MB value panel). It splits the cost of
K8 (the blocked-ELL SpMM) into the value stream, the X gather and the
product's shape, as a ladder of kernels that each differ from their
neighbour in one thing (blocks of 8 warps, one per block row; v3 and v3b
stream the values persistently, one block per SM):

  v5_batched_hi   Y = A X, X slices read from L1/L2 as used, 3xTF32 mma
  v1_panel_hi     v5_hi with each row's X panel staged in shared memory
  v6_smem_hi      v5_hi with the tile's cols staged in shared memory
  v5_batched_def  v5 with bf16 operands, mma.sync m16n8k16 (transposed),
                  X by 16-byte loads
  v2_panel_def    v5_def with X through shared memory: per 8-row unit the
                  union of its block columns, each slice staged once
  v3_stream       no gather: each block row @ the fixed panel X[0 : S b]
  v3b_onedot      v3's function as one (64, S b) product per 64 rows
  v4_gather       the gather alone: per tile the sum of its slices

and, timed beside at every m, the ported kernels the reference compared
them with: v0_current (K8, bsr_matmat), v7_pairs (K11, bellpairs_matmat on
the BELLPairs layout of K and M), v9_km (K12, bellpairs_km_matmat, held to
(K + M) X in f64 at 1e-5 as exp_spmm.py:361-366).

    python -m maxwell_tpu_torch.bench.exp_spmm [--grid N]
        [--device cuda|cpu] [--out PATH]

The layout is the port's BSRMatrix.from_csr (its slot order follows
scipy's builder, not the reference's); X is drawn from numpy's
default_rng(m). Per variant and m: ms (median of 20 launches), plain_ms,
max_abs_err against the plain version (the run fails above 1e-5 of
max|plain|, or where a _hi or _def variant's second run differs from its
first, `bitwise_repeat`; the _def variants against the plain product of
bf16-rounded operands, with their error against the f32 product beside, and
their launch: v2's unit, pass width, largest union and shared memory, on
the card the registers and resident blocks of both), bound_ms /
bound_by at the card's published rates (the probe's inputs once: values,
cols, X, Y; 2 nbr b S b m operations at f32 for _hi, bf16 for _def, v3,
v3b), roofline_ms and pct_roofline (the reference's yardsticks over the
copy bandwidth measured in the same run: the layout roofline
exp_spmm.py:106-108, for v7 the pairs roofline :309-311, for v9 the fused
roofline :346-349), and library_ms of one PyTorch call (`library` says
what it includes and excludes; the bf16 variants' on the f32 operands the
kernels read, TF32 allowed for that call, and beside it library_bf16_ms,
the call on operands rounded to bf16 beforehand, `library_bf16`). Runs on
the card unless --device cpu is given; there the plain versions run and
nothing is timed. Writes JSON to --out (default
build/maxwell_tpu_torch/probes/exp_spmm_results.json); never the
reference's exp_spmm_results.json.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from maxwell_tpu_torch.bench.exp_gather import LIB_TOL_SUM, bag_sum
from maxwell_tpu_torch.bench.exp_union import (
    LIB_TOL_BF16,
    PROBE_DIR,
    device_of,
    held,
    write,
)
from maxwell_tpu_torch.bench.timing import (
    bound_ms,
    copy_bandwidth,
    median_ms,
    torch_csr,
    with_tf32,
)
from maxwell_tpu_torch.kernels import bellpairs_spmm as kp
from maxwell_tpu_torch.kernels import bsr_spmm
from maxwell_tpu_torch.kernels import spmm_probes as spp
from maxwell_tpu_torch.sparse import bsr as _bsr
from maxwell_tpu_torch.utils.precision import fp32_true

TOL = 1e-5  # of max|plain|: f32 sums in another order than the plain's
GRID = 24
MS = spp.MS
R, B = spp.R, spp.B
HI = ("v1_panel_hi", "v5_batched_hi", "v6_smem_hi")
DEF = ("v2_panel_def", "v5_batched_def")
STREAM = ("v3_stream", "v3b_onedot")


def make_x(rows: int, m: int) -> np.ndarray:
    return np.random.default_rng(m).standard_normal((rows, m)).astype(
        np.float32)


def args_of(name, V, cols, X):
    if name in STREAM:
        return V, X
    if name == "v4_gather":
        return cols, X
    return V, cols, X


def library(name, V, cols, X, Kcsr, n):
    """(what, call, as_plain, tol) of one PyTorch call computing the
    variant's function: the call runs on operands formed beforehand;
    as_plain maps its output onto the plain version's (untimed); tol is
    the bound against the plain version, of max|plain|."""
    nbr, S = cols.shape
    m = X.shape[1]
    if name in HI:
        Xn = X[:n]
        return ("torch.sparse.mm on the f32 CSR of K (n rows; the padded "
                "rows of Y are zero)", lambda: torch.sparse.mm(Kcsr, Xn),
                lambda out: F.pad(out, (0, 0, 0, nbr * B - n)), TOL)
    if name in DEF:
        Vf = V.view(nbr, B, S * B)
        P = spp.gathered_panel(cols, X)
        return ("torch.bmm on the f32 values and the f32 panel gathered "
                "beforehand, TF32 allowed for this call (reads the "
                "kernels' value bytes; excludes the gather)",
                with_tf32(lambda: torch.bmm(Vf, P)),
                lambda out: out.reshape(nbr * B, m), LIB_TOL_BF16)
    if name in STREAM:
        Xs = X[:S * B]
        return ("torch.matmul(blocks2d, X[:S b]) on the probe's f32 "
                "operands, TF32 allowed for this call (reads the kernels' "
                "bytes)", with_tf32(lambda: torch.matmul(V, Xs)),
                lambda out: out, LIB_TOL_BF16)
    if name == "v4_gather":
        call, as_plain = bag_sum(cols, X, S, B)
        return ("F.embedding_bag sum over X viewed as (nbr, 8 m) slices, "
                "one bag of R S per tile (excludes the R-fold tile)", call,
                as_plain, LIB_TOL_SUM)
    raise KeyError(name)


def library_bf16(name, V, cols, X):
    """(what, call, as_plain, tol) of a bf16 variant's second library call
    (DEF and STREAM): the first call on operands rounded to bf16
    beforehand, which reads half the kernels' value bytes."""
    if name in DEF:
        nbr, S = cols.shape
        Vb = V.view(nbr, B, S * B).bfloat16()
        Pb = spp.gathered_panel(cols, X).bfloat16()
        return ("torch.bmm of bf16 operands on the panel gathered and "
                "rounded beforehand (reads half the value bytes; excludes "
                "the gather; bf16 output)", lambda: torch.bmm(Vb, Pb),
                lambda out: out.float().reshape(nbr * B, X.shape[1]),
                LIB_TOL_BF16)
    if name in STREAM:
        Vb, Xb = V.bfloat16(), X[:V.shape[1]].bfloat16()
        return ("torch.matmul(blocks2d, X[:S b]) with both operands rounded "
                "to bf16 beforehand (reads half the value bytes; bf16 "
                "output)", lambda: torch.matmul(Vb, Xb),
                lambda out: out.float(), LIB_TOL_BF16)
    raise KeyError(name)


@fp32_true
def run(grid: int = GRID, ms=MS, device="cuda") -> dict:
    """Every variant at each m on the grid^3 RCM brick's K on `device`,
    then K8, K11 and K12 beside; raises if a kernel or a library call
    disagrees with its plain version. Returns the results."""
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.bellpairs import BELLPairs
    from maxwell_tpu_torch.sparse.bsr import BSRMatrix
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    dev = device_of(device)
    timed = dev.type == "cuda"
    prob = PermutedProblem(BrickCavity3D(nx=grid, ny=grid, nz=grid))
    K, Mm = prob.K.tocsr(), prob.M.tocsr()
    A = BSRMatrix.from_csr(K, block=8, device=dev)
    AP = BELLPairs.from_csr(K, B=Mm, device=dev)
    V, cols = spp.panel_values(A.blocks), A.cols
    nbr, S, n = A.n_brows, A.slots, A.n
    KM = (K + Mm).tocsr()
    Kcsr = torch_csr(K, dev)
    layout_bytes = V.numel() * 4 + cols.numel() * 4
    results = {
        "device": torch.cuda.get_device_name(dev) if timed else "cpu",
        "grid": grid, "n": n, "nnz": int(K.nnz), "nbr": nbr, "S": S, "b": B,
        "tiles": nbr // R, "layout_bytes": layout_bytes,
        "pairs_streamed_bytes": AP.nnz_streamed * 4,
    }
    bw = None
    if timed:
        bw = copy_bandwidth(dev)
        results["bw_GBps"] = bw / 1e9
    for m in ms:
        X = torch.from_numpy(make_x(A.n_padded, m)).to(dev)
        xy = 2 * A.n_padded * m * 4  # X read once, Y written once
        flops = 2 * nbr * B * S * B * m
        roofs = {  # the reference's yardsticks, bytes
            "layout": layout_bytes + xy,
            "pairs": AP.nnz_streamed * 4 + AP.cols.numel() * 4
            + 2 * AP.n_padded * m * 4,
            "km": 2 * AP.nnz_streamed * 4 + AP.cols.numel() * 4
            + 3 * AP.n_padded * m * 4,
        }
        res = {}
        for kern in spp.KERNELS:
            name = kern.__name__
            args = args_of(name, V, cols, X)
            plain = spp.PLAIN_OF[kern]
            got, want = kern(*args), plain(*args)
            err, scale = held(name, got, want)
            row = {"max_abs_err": err, "rel_err": err / scale}
            if name in HI + DEF:  # one writer per output, no atomics
                row["bitwise_repeat"] = torch.equal(got, kern(*args))
                if not row["bitwise_repeat"]:
                    raise AssertionError(f"{name}: two runs differ")
            if name in DEF:
                row["launch"] = _def_launch(name, cols, X, timed)
                f32 = spp.product_plain(V, cols, X)
                row["err_vs_f32"] = (got - f32).abs().max().item()
                row["rel_err_vs_f32"] = (row["err_vs_f32"]
                                         / f32.abs().max().item())
                del f32
            what, call, as_plain, tol = library(name, V, cols, X, Kcsr, n)
            row["library"] = what
            row["library_max_abs_err"] = held(
                f"{name} library", as_plain(call()), want, tol)[0]
            if name in DEF + STREAM:
                what2, call2, as_plain2, tol2 = library_bf16(
                    name, V, cols, X)
                row["library_bf16"] = what2
                row["library_bf16_max_abs_err"] = held(
                    f"{name} library_bf16", as_plain2(call2()), want,
                    tol2)[0]
            if timed:
                if name in STREAM:
                    nbytes = V.numel() * 4 + S * B * m * 4 + xy // 2
                elif name == "v4_gather":
                    nbytes = cols.numel() * 4 + xy
                else:
                    nbytes = layout_bytes + xy
                kind = "f32" if name in HI or name == "v4_gather" else "bf16"
                ops = nbr * S * B * m if name == "v4_gather" else flops
                b_ms, b_by = bound_ms(nbytes, ops, kind)
                ms_ = median_ms(lambda: kern(*args))
                roof = roofs["layout"] / bw * 1e3
                row.update(ms=ms_, plain_ms=median_ms(lambda: plain(*args)),
                           bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                           operations=ops, roofline_ms=roof,
                           pct_roofline=100 * roof / ms_,
                           library_ms=median_ms(call))
                if name in DEF + STREAM:
                    row["library_bf16_ms"] = median_ms(call2)
            res[name] = row
            del got, want
        res.update(_beside(A, AP, X, KM, m, roofs, bw))
        results[f"m{m}"] = res
    return results


def _def_launch(name, cols, X, timed) -> dict:
    """A _def rung's launch at X's width: v2's host plan (unit, pass width,
    passes, largest union, shared memory), and on the card the kernel's
    warps, registers, local memory and resident blocks per SM."""
    m = X.shape[1]
    if name == "v5_batched_def":
        out = {"rows_a_warp": 1}
        shape = ("v5", m, 0)
    else:
        out = spp.union_plan(spp.largest_union(cols)[0], cols.shape[1], m,
                             X.shape[0])
        shape = ("v2", out["pass_width"], out["smem"], out["passes"])
    if timed:
        out.update(spp.def_launch_shape(*shape))
    return out


def _beside(A, AP, X, KM, m, roofs, bw) -> dict:
    """K8, K11 and K12 at width m against their plain arithmetic
    (uncounted; K12's sum against (K + M) X in f64), timed on the card."""
    n = A.n
    y0 = bsr_spmm.bsr_matmat(A, X)
    y7 = kp.bellpairs_matmat(AP, X, "a")
    yk, ym = kp.bellpairs_km_matmat(AP, X)
    want_km = KM @ X[:n].double().cpu().numpy()
    err9 = float(np.abs((yk + ym)[:n].double().cpu().numpy() - want_km).max()
                 / max(np.abs(want_km).max(), 1e-30))
    if not err9 < TOL:
        raise AssertionError(f"v9_km: relative error {err9:.3e} against "
                             f"(K + M) X in f64")
    out = {
        "v0_current": {"kernel": "K8 bsr_matmat", "max_abs_err": held(
            "v0_current", y0, _bsr.bsr_matmat_ref(A, X))[0]},
        "v7_pairs": {"kernel": "K11 bellpairs_matmat", "max_abs_err": held(
            "v7_pairs", y7, kp._pairs(AP, X, "a"))[0]},
        "v9_km": {"kernel": "K12 bellpairs_km_matmat",
                  "rel_err_vs_f64": err9},
    }
    if bw is not None:
        calls = {"v0_current": (lambda: bsr_spmm.bsr_matmat(A, X), "layout"),
                 "v7_pairs": (lambda: kp.bellpairs_matmat(AP, X, "a"),
                              "pairs"),
                 "v9_km": (lambda: kp.bellpairs_km_matmat(AP, X), "km")}
        for name, (call, roof) in calls.items():
            ms_ = median_ms(call)
            r_ms = roofs[roof] / bw * 1e3
            out[name].update(ms=ms_, roofline=roof, roofline_ms=r_ms,
                             pct_roofline=100 * r_ms / ms_)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=GRID)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(PROBE_DIR / "exp_spmm_results.json"))
    args = ap.parse_args(argv)
    results = run(args.grid, device=args.device)
    write(results, args.out)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
