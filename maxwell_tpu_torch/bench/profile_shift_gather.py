"""Where the K15f shift kernel's and gather_sum's time goes, on the card:
each kernel launched with the host plan's choice and beside it with the
choices the plan turned down, on the probes' own data.

  shift   p0, p1, p3, p5 and p6 on the 64^3 field at m 8 and 9 (and p3 on
          the grid-91 field at m 9, K4's output count), with the plan's
          x-chunks and with chunks of 1, 2, 3 and 6 planes (the same
          window), each as near-equal chunks
  gather  v4_gather's layout (the 24^3 RCM brick's K) at m 8, 32, 64, 128
          and g0 on the probe's draws (T 298, S 64), each on grids of 1,
          2 (the plan's) and 4 blocks an SM

Every launch is held to its plain version (1e-5 of max|plain|). Times are
medians of 20 launches (CUDA events), beside the card's name and power
limit as nvidia-smi prints them.

    python -m maxwell_tpu_torch.bench.profile_shift_gather [--out PATH]

Runs on the card only (it times); writes JSON to --out (default
build/maxwell_tpu_torch/probes/profile_shift_gather.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch

from maxwell_tpu_torch.bench import exp_gather, exp_stencil2
from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write
from maxwell_tpu_torch.bench.timing import median_ms
from maxwell_tpu_torch.kernels import gather_probes as gpr
from maxwell_tpu_torch.kernels import stencil_probes as sp

TOL = 1e-5  # of max|plain|
CHUNKS = (1, 2, 3, 6)
SHIFT_CASES = ("p0", "p1", "p3", "p5", "p6")


def _held(label, got, want) -> None:
    err = ((got - want).abs().max() / want.abs().max()).item()
    if not err <= TOL:
        raise AssertionError(f"{label}: relative error {err:.3e}")


def _shift(field, m, case) -> dict:
    """The case with the plan's x-chunks and with CHUNKS planes a block."""
    plan = sp.field_plan(case, field, m)
    NX = plan.NX
    want = sp.shift_plain(case, field, m)
    out = torch.empty_like(want)
    row = {"plan_chunk": plan.chunk_x}
    for chunk in ("plan", *CHUNKS):
        pl = plan if chunk == "plan" else dataclasses.replace(
            plan, grid_x=-(-NX // chunk), chunk_x=chunk)
        sp.run_plan(pl, field, out)
        _held(f"{case} chunk {chunk}", out, want)
        row[f"chunk_{chunk}_ms"] = median_ms(
            lambda: sp.run_plan(pl, field, out))
    return row


def _sum(cols, X, sms) -> dict:
    """gather_sum's times on grids of 1, 2 (the plan's) and 4 blocks an
    SM, each held to its plain version."""
    want = gpr.sum_plain(cols, X)
    plan = gpr.gather_plan(cols, X.shape[1], sms)
    Y = torch.empty_like(want)
    row = {"plan_grid": plan.grid}
    for k in (1, 2, 4):
        pl = dataclasses.replace(plan, grid=min(k * sms, plan.groups))
        gpr.run_plan(pl, cols, X, Y)
        _held(f"m {pl.m} grid {pl.grid}", Y, want)
        row[f"grid_{k}x_ms"] = median_ms(lambda: gpr.run_plan(pl, cols, X, Y))
    return row


def run(device="cuda") -> dict:
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.bsr import BSRMatrix
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    dev = device_of(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_shift_gather times kernels: it needs "
                           "the card")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"device": torch.cuda.get_device_name(dev), "sms": sms}
    for grid, ms, cases in ((64, (8, 9), SHIFT_CASES), (91, (9,), ("p3",))):
        for m in ms:
            field = torch.from_numpy(exp_stencil2.make_field(grid, m)).to(dev)
            out[f"shift_g{grid}_m{m}"] = {c: _shift(field, m, c)
                                         for c in cases}
            del field
    A = BSRMatrix.from_csr(PermutedProblem(BrickCavity3D(
        nx=24, ny=24, nz=24)).K.tocsr(), block=8, device=dev)
    for m in gpr.SLICE_MS:
        X = torch.from_numpy(np.random.default_rng(m).standard_normal(
            (A.n_padded, m)).astype(np.float32)).to(dev)
        out[f"v4_m{m}"] = _sum(A.cols, X, sms)
    d = exp_gather.make_inputs(exp_gather.T_REF, exp_gather.S_REF)
    cols, X = (torch.from_numpy(d[k]).to(dev) for k in ("cols", "X"))
    out["g0"] = _sum(cols, X, sms)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out",
                    default=str(PROBE_DIR / "profile_shift_gather.json"))
    args = ap.parse_args(argv)
    results = run()
    results["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    write(results, args.out)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
