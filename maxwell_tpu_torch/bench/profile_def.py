"""Where the K15c bf16 rungs' time goes, on the card: v5_batched_def and
v2_panel_def on the probe's layout (the 24^3 RCM brick's K, 4,768 block
rows of S = 64 slots) at m 8, 32, 64, 128, each timed three ways:

  layout      the probe's own cols: what exp_spmm times
  no_gather   every slot's block column 0: the same values, products and
              launch, but one X slice (v2: a union of one entry a unit),
              so the X gather or staging all but vanishes
  one_pass    (v2 from m 64) the layout's cols at m 32, the first of the
              passes: what each further pass of 32 columns adds is
              (layout - one_pass) / (passes - 1)

and the launch each one makes (v2: unit, pass width, largest union,
shared memory; both: registers, resident blocks per SM). Every run is held
to its plain version (1e-5 of max|plain|). Times are medians of 20
launches (CUDA events), beside the card's name and power limit as
nvidia-smi prints them.

    python -m maxwell_tpu_torch.bench.profile_def [--grid N] [--out PATH]

Runs on the card only (it times); writes JSON to --out (default
build/maxwell_tpu_torch/probes/profile_def.json).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write
from maxwell_tpu_torch.bench.timing import median_ms
from maxwell_tpu_torch.kernels import spmm_probes as spp

TOL = 1e-5  # of max|plain|: f32 sums of bf16 products in another order


def _timed(kern, V, cols, X) -> float:
    """The kernel's median time, after holding it to its plain version."""
    got, want = kern(V, cols, X), spp.product_def_plain(V, cols, X)
    err = ((got - want).abs().max() / want.abs().max()).item()
    if not err <= TOL:
        raise AssertionError(f"{kern.__name__}: relative error {err:.3e}")
    return median_ms(lambda: kern(V, cols, X))


def _launch(name, cols, X) -> dict:
    m = X.shape[1]
    if name == "v5_batched_def":
        return spp.def_launch_shape("v5", m)
    plan = spp.union_plan(spp.largest_union(cols)[0], cols.shape[1], m,
                          X.shape[0])
    return {**plan, **spp.def_launch_shape(
        "v2", plan["pass_width"], plan["smem"], plan["passes"])}


def run(grid: int = 24, device="cuda") -> dict:
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.bsr import BSRMatrix
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    dev = device_of(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_def times kernels: it needs the card")
    prob = PermutedProblem(BrickCavity3D(nx=grid, ny=grid, nz=grid))
    A = BSRMatrix.from_csr(prob.K.tocsr(), block=8, device=dev)
    V, cols = spp.panel_values(A.blocks), A.cols
    zero = torch.zeros_like(cols)
    out = {"device": torch.cuda.get_device_name(dev), "grid": grid,
           "nbr": A.n_brows, "S": A.slots}
    for m in spp.MS:
        X = torch.from_numpy(np.random.default_rng(m).standard_normal(
            (A.n_padded, m)).astype(np.float32)).to(dev)
        row = {}
        for kern in (spp.v5_batched_def, spp.v2_panel_def):
            name = kern.__name__
            r = {"layout_ms": _timed(kern, V, cols, X),
                 "no_gather_ms": _timed(kern, V, zero, X),
                 "launch": _launch(name, cols, X)}
            r["gather_ms"] = r["layout_ms"] - r["no_gather_ms"]
            if name == "v2_panel_def" and m >= 64:
                passes = r["launch"]["passes"]
                r["one_pass_ms"] = _timed(kern, V, cols, X[:, :32].clone())
                r["pass_ms"] = ((r["layout_ms"] - r["one_pass_ms"])
                                / (passes - 1))
            row[name] = r
        out[f"m{m}"] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=24)
    ap.add_argument("--out", default=str(PROBE_DIR / "profile_def.json"))
    args = ap.parse_args(argv)
    results = run(args.grid)
    results["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    write(results, args.out)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
