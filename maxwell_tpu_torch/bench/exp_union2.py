"""K15b on the card: the union-kernel variant study of
maxwell_tpu/bench/exp_union2.py on the real RCM curl-curl operator (24^3:
n = 38,088, nnz 1,173,840), at m = 8 (the reference probe's width) and
m = 9 (the LOBPCG block on the solve path). Each variant is built with the
(chunk_lanes, pack) its name states:

  prod512   (512, 1)   K2, the shipped kernel (X block staged in shared
                       memory)
  cat512    (512, 1)   union_unstaged (K2's walk of the live form, X read
                       from global memory) and K2
  cat1024   (1024, 1)  the same pair
  pair1024  (1024, 2)
  quad1024  (1024, 4)
  pair512   (512, 2)

so every layout gives a staged (K2) against unstaged pair. (The
reference's prod512/cat512 call BELLUnion.from_csr with its defaults,
which are now (1024, 2): that file no longer measures what the names say.)

    python -m maxwell_tpu_torch.bench.exp_union2 [--device cuda|cpu]
        [--out PATH] [--grid N]

Per variant and m: time, pct of the kernel's own roofline (the bytes it
moves over the copy bandwidth measured in the same run: the live form's,
timing.union_bytes, for both kernels, which read only it; the reference's
own_bytes, exp_union2.py:130's full layout, is kept beside) and of the CSR
bound (the CSR's bytes at 3.35 TB/s), true nnz/s, stored MB and n_chunks,
the max relative error against scipy's K @ X in f64 and against the plain
version (the run fails above 1e-5 of the reference's max, or where
union_unstaged is not bit for bit K2: `bitwise_equal_k2`), the plain
version's time, and torch.sparse.mm on the CSR as the library line. One
layout is built at a time and freed after. Runs on the card unless
--device cpu is given (then the plain versions run and nothing is timed).
Writes JSON to --out (default
build/maxwell_tpu_torch/probes/exp_union2_results.json).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write
from maxwell_tpu_torch.bench.timing import (
    bound_ms,
    copy_bandwidth,
    csr_bytes,
    median_ms,
    torch_csr,
    union_bytes,
)
from maxwell_tpu_torch.kernels import spmm
from maxwell_tpu_torch.kernels import union_probes as up
from maxwell_tpu_torch.utils.precision import fp32_true

TOL = 1e-5
# name: (chunk_lanes, pack)
VARIANTS = {
    "prod512": (512, 1),
    "cat512": (512, 1),
    "cat1024": (1024, 1),
    "pair1024": (1024, 2),
    "quad1024": (1024, 4),
    "pair512": (512, 2),
}


def own_bytes(A, m: int) -> int:
    """The variant's own roofline bytes (exp_union2.py:130): the stored
    values with their fill, the union column table, X read and Y written
    (both n_padded rows)."""
    return A.nnz_dense * 4 + A.ucols.numel() * 4 + 2 * A.n_padded * m * 4


def kernels_of(name: str) -> dict:
    """The kernels a variant runs: K2 alone for prod*, else the unstaged
    kernel and K2 on the same layout."""
    def staged(A, X):
        return spmm.bellunion_matmat(A, X, "a", "highest")

    if name.startswith("prod"):
        return {"staged": staged}
    return {"unstaged": up.union_unstaged, "staged": staged}


@fp32_true
def run(grid: int = 24, ms=(8, 9), device="cuda") -> dict:
    """Every variant on the grid^3 RCM brick on `device`; raises if a
    kernel is off scipy or its plain version. Returns the results."""
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.bellunion import BELLUnion
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    dev = device_of(device)
    timed = dev.type == "cuda"
    Kcsr = PermutedProblem(BrickCavity3D(nx=grid, ny=grid, nz=grid)).K.tocsr()
    n, nnz = Kcsr.shape[0], int(Kcsr.nnz)
    results = {"device": torch.cuda.get_device_name(dev) if timed else "cpu",
               "grid": grid, "n": n, "nnz": nnz, "variants": {}}
    if timed:
        bw = copy_bandwidth(dev)
        results["bw_GBps"] = bw / 1e9
        lib = torch_csr(Kcsr, dev)
    rng = np.random.default_rng(0)
    for name, (cl, pack) in VARIANTS.items():
        t0 = time.perf_counter()
        A = BELLUnion.from_csr(Kcsr, chunk_lanes=cl, pack=pack, device=dev)
        entry = {"chunk_lanes": cl, "pack": pack, "n_chunks": A.n_chunks,
                 "storedMB": A.nnz_dense * 4 / 1e6,
                 "build_s": time.perf_counter() - t0}
        for m in ms:
            Xh = rng.standard_normal((A.n_cols_padded, m)).astype(np.float32)
            X = torch.from_numpy(Xh).to(dev)
            ref = Kcsr @ Xh[:n].astype(np.float64)
            ref_scale = np.abs(ref).max()
            want = up.unstaged_plain(A, X)
            scale = want.abs().max().item()
            per_m = {}
            if timed:
                Xn = X[:n].contiguous()
                b_ms, b_by = bound_ms(csr_bytes(Kcsr, m), 2 * nnz * m, "f32")
                per_m.update(
                    plain_ms=median_ms(lambda: up.unstaged_plain(A, X)),
                    library_ms=median_ms(lambda: torch.sparse.mm(lib, Xn)),
                    bound_ms=b_ms, bound_by=b_by, own_bytes=own_bytes(A, m),
                    live_bytes=union_bytes(A, 1, m)[0])
            outs = {}
            for kind, fn in kernels_of(name).items():
                Y = outs[kind] = fn(A, X)
                err = float(np.abs(Y[:n].cpu().numpy() - ref).max()
                            / ref_scale)
                abs_err = (Y - want).abs().max().item()
                if not (err <= TOL and abs_err <= TOL * scale):
                    raise AssertionError(
                        f"{name} {kind} m={m}: {err:.3e} of max|K X| against "
                        f"scipy, {abs_err:.3e} against the plain version "
                        f"(limit {TOL} of {scale:.3e})")
                row = {"err": err, "max_abs_err": abs_err,
                       "rel_err": abs_err / scale}
                if timed:
                    ms_ = median_ms(lambda: fn(A, X))
                    # both kernels read the live form; the reference's
                    # own_bytes (the full layout) stays in the record
                    nbytes = per_m["live_bytes"]
                    row.update(
                        ms=ms_, time_s=ms_ * 1e-3,
                        pct=100 * nbytes / bw / (ms_ * 1e-3),
                        pct_csr_bound=100 * per_m["bound_ms"] / ms_,
                        nnz_per_s=nnz / (ms_ * 1e-3))
                per_m[kind] = row
            if "unstaged" in outs:  # K2's walk and order: bit for bit K2
                same = torch.equal(outs["unstaged"], outs["staged"])
                per_m["unstaged"]["bitwise_equal_k2"] = same
                if not same:
                    raise AssertionError(f"{name} m={m}: union_unstaged is "
                                         "not bit for bit K2 (highest)")
            entry[f"m{m}"] = per_m
            del X, want, outs
        results["variants"][name] = entry
        del A
        if timed:
            torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out",
                    default=str(PROBE_DIR / "exp_union2_results.json"))
    ap.add_argument("--grid", type=int, default=24,
                    help="edge cells of the RCM brick (default 24)")
    args = ap.parse_args(argv)
    results = run(args.grid, device=args.device)
    write(results, args.out)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
