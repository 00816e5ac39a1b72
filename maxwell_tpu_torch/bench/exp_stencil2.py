"""K15f on the card: the tap-stencil shifted-read probe of
maxwell_tpu/bench/exp_stencil2.py. Per x-plane of a padded field, 33 taps
(1 + t) * (a shifted read) per output, in seven forms:

  p0  unshifted (one read, 33 FMAs)     p4  dy shifts only
  p1  dz shifts of +-m lanes            p5  p1 by warp shuffles
  p2  dy and dz shifts                  p6  p3 by warp shuffles
  p3  three x-planes, 11 taps each (the tap stencil's pattern)

    python -m maxwell_tpu_torch.bench.exp_stencil2 [--grid N] [--ms 8 9]
        [--device cuda|cpu] [--out PATH]

The field is (NX + 2, Y + 2, ZM + 2m) f32 with NX = Y = grid + 2 and
ZM = (grid + 2) m, drawn from numpy's default_rng(0) as the reference draws
it (exp_stencil2.py:101-105); the output is (NX, Y, ZM). m 8 is the
reference's default, m 9 the LOBPCG block of the 64^3 stencil solve. Per
case and m: ms (median of 20 launches), ns_per_output, plain_ms, bound_ms /
bound_by and pct_bound at the card's published rates (the field read once
and the output written once; 2 x 33 flops per output at the f32 rate),
`launch` (the kernel's plan: window, chunk, grid, shared memory, the bytes
it stages beside the field's; registers and resident blocks per SM), and
the max error against the plain version (the run fails above 1e-5 of
max|plain|; p5 is also held to p1's plain output and p6 to p3's).
library_ms: every case is one 3-D convolution of the field with a 3 x 3 x 3
filter (its 33 coefficients summed per distinct (dx, dy, dz)) dilated by m
along z, so one F.conv3d call (TF32 off) computes it; it is held to the
plain version at the same tolerance. Then K4 (the fused K/M tap apply,
csrc/stencil_taps.cu) on the grid^3 stencil pencil at m 9, timed beside p3
on a field with as many outputs (per output, K4 reads X and the mask at
each of its taps and writes both K and M; p3 reads the field once per tap),
with p3's bound and launch there.
Runs on the card unless --device cpu is given; there the plain versions and
the convolution run and nothing is timed. Writes JSON to --out (default
build/maxwell_tpu_torch/probes/exp_stencil2_results.json).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write
from maxwell_tpu_torch.bench.timing import bound_ms, median_ms
from maxwell_tpu_torch.kernels import stencil_probes as sp
from maxwell_tpu_torch.utils.precision import fp32_true

TOL = 1e-5  # of max|plain|: fmaf in the kernel, mul then add in torch
SAME_AS = {"p5": "p1", "p6": "p3"}  # the roll forms' functions


def make_field(grid: int, m: int, seed: int = 0) -> np.ndarray:
    """The reference's padded field (exp_stencil2.py:98-105)."""
    n = grid + 2
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n + 2, n + 2, n * m + 2 * m)).astype(
        np.float32)


def conv_weight(case: str) -> torch.Tensor:
    """The case's 33 taps as one (3, 3, 3) filter, W[1 + dx, 1 + dy,
    1 + dz] the sum of the coefficients at that offset."""
    W = torch.zeros((3, 3, 3), dtype=torch.float64)
    for dx, dy, dz, c in sp._taps(case):
        W[1 + dx, 1 + dy, 1 + dz] += c
    return W.float()


def library(field: torch.Tensor, W: torch.Tensor, m: int) -> torch.Tensor:
    """The case's output by one PyTorch call: F.conv3d of the field with
    the case's filter, dilated by m along z (cross-correlation: output
    (i, y, z) reads field[i + 1 + dx, 1 + y + dy, m + z + dz m])."""
    return F.conv3d(field[None, None], W[None, None],
                    dilation=(1, 1, m))[0, 0]


def _check(label, got, want, tol=TOL):
    """Max abs error of got against want; raises past tol * max|want|."""
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if got.shape != want.shape or not err <= tol * scale:
        raise AssertionError(f"{label}: max error {err:.3e} > {tol} * "
                             f"{scale:.3e} against the plain version")
    return err, scale


def _k4(grid: int, dev: torch.device, timed: bool) -> dict:
    """K4, fused K/M at m 9, on the grid^3 PEC stencil pencil, against its
    plain version (uncounted arithmetic); beside it p3 on the field whose
    (g + 2)^3 m outputs are nearest K4's n_padded m. Timed on the card,
    with the time per output element of each."""
    from maxwell_tpu_torch.kernels import stencil_taps as kst
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D

    pencil = StencilPencil3D.build(nx=grid, ny=grid, nz=grid,
                                   dtype=torch.float32, device=dev)
    m = 9
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (pencil.n_padded, m)).astype(np.float32)).to(dev)

    def kern():
        return kst.stencil_taps(X, pencil.mask, pencil.taps, pencil.shape,
                                True, True)

    got = kern()
    want = kst.taps_plain(X, pencil.mask, pencil.taps, pencil.shape, True,
                          True)
    scale = max(w.abs().max().item() for w in want)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if not err <= TOL * scale:
        raise AssertionError(f"K4: max error {err:.3e} > {TOL} * "
                             f"{scale:.3e} against the plain version")
    outputs = pencil.n_padded * m  # of K, and as many of M
    g3 = max(round(pencil.n_padded ** (1 / 3)) - 2, 1)
    field = torch.from_numpy(make_field(g3, m)).to(dev)
    p3_out = (g3 + 2) ** 3 * m
    p3_err, _ = _check(f"p3 at grid {g3}", sp.shift_probe("p3", field, m),
                       sp.shift_plain("p3", field, m))
    p3_bytes = (field.numel() + (g3 + 2) ** 3 * m) * 4
    row = {"grid": grid, "m": m, "n_padded": pencil.n_padded,
           "outputs": outputs, "max_abs_err": err,
           "p3_same_outputs": {"grid": g3, "outputs": p3_out,
                               "max_abs_err": p3_err, "bytes": p3_bytes}}
    if timed:
        row["ms"] = median_ms(kern)
        row["ns_per_output"] = row["ms"] * 1e6 / outputs
        t = median_ms(lambda: sp.shift_probe("p3", field, m))
        b_ms, b_by = bound_ms(p3_bytes, 2 * 33 * p3_out, "f32")
        row["p3_same_outputs"].update(
            ms=t, ns_per_output=t * 1e6 / p3_out, bound_ms=b_ms,
            bound_by=b_by, launch=shift_launch("p3", field, m))
        row["k4_over_p3_per_output"] = (row["ns_per_output"]
                                        / row["p3_same_outputs"]
                                        ["ns_per_output"])
    return row


def shift_launch(case, field, m) -> dict:
    """The shift kernel's launch on the card for this field: the plan's
    summary (sp.ShiftPlan.summary) and the kernel's registers, local
    memory and resident blocks per SM."""
    plan = sp.field_plan(case, field, m)
    return {**plan.summary(), **sp.launch_shape(plan)}


@fp32_true
def run(grid: int = 64, ms=(8, 9), device="cuda") -> dict:
    """Every case at each m on `device`, then K4 at grid^3; raises if a
    kernel or the library call disagrees with its plain version. Returns
    the results."""
    dev = device_of(device)
    timed = dev.type == "cuda"
    results = {"device": torch.cuda.get_device_name(dev) if timed else "cpu",
               "grid": grid}
    for m in ms:
        field = torch.from_numpy(make_field(grid, m)).to(dev)
        NX, Y = field.shape[0] - 2, field.shape[1] - 2
        ZM = field.shape[2] - 2 * m
        nbytes = (field.numel() + NX * Y * ZM) * 4
        flops = 2 * 33 * NX * Y * ZM
        b_ms, b_by = bound_ms(nbytes, flops, "f32")
        res = {"NX": NX, "Y": Y, "ZM": ZM, "field_bytes": field.numel() * 4,
               "bytes": nbytes, "flops": flops, "bound_ms": b_ms,
               "bound_by": b_by}
        plains = {}
        for case in sp.CASES:
            got = sp.shift_probe(case, field, m)
            want = plains[case] = sp.shift_plain(case, field, m)
            err, scale = _check(f"{case} m={m}", got, want)
            W = conv_weight(case).to(dev)
            lib_err, _ = _check(f"{case} m={m} conv3d",
                                library(field, W, m), want)
            row = {"max_abs_err": err, "rel_err": err / scale,
                   "library": "F.conv3d, 3x3x3 filter dilated (1, 1, m)",
                   "library_err": lib_err}
            if case in SAME_AS:
                twin = plains[SAME_AS[case]]
                err2 = (got - twin).abs().max().item()
                if not err2 <= TOL * scale:
                    raise AssertionError(
                        f"{case} m={m} is not {SAME_AS[case]}'s function: "
                        f"{err2:.3e}")
                row[f"err_vs_{SAME_AS[case]}"] = err2
            if timed:
                t = median_ms(lambda: sp.shift_probe(case, field, m))
                row.update(ms=t, ns_per_output=t * 1e6 / (NX * Y * ZM),
                           plain_ms=median_ms(
                               lambda: sp.shift_plain(case, field, m)),
                           bound_ms=b_ms, bound_by=b_by,
                           pct_bound=100 * b_ms / t,
                           library_ms=median_ms(
                               lambda: library(field, W, m)),
                           launch=shift_launch(case, field, m))
            res[case] = row
        del plains
        results[f"m{m}"] = res
    results["k4"] = _k4(grid, dev, timed)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--ms", type=int, nargs="+", default=[8, 9])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out",
                    default=str(PROBE_DIR / "exp_stencil2_results.json"))
    args = ap.parse_args(argv)
    results = run(args.grid, tuple(args.ms), args.device)
    write(results, args.out)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
