"""Where the K15f shift kernel's, gather_sum's and K15e g2's and g3's time
goes, on the card: each kernel launched with the host plan's choice and
beside it with the choices the plan turned down, on the probes' own data.

  shift   p0, p1, p3, p5 and p6 on the 64^3 field at m 8 and 9 (and p3 on
          the grid-91 field at m 9, K4's output count), with the plan's
          x-chunks and with chunks of 1, 2, 3 and 6 planes (the same
          window), each as near-equal chunks
  gather  v4_gather's layout (the 24^3 RCM brick's K) at m 8, 32, 64, 128
          and g0 on the probe's draws (T 298, S 64), each on grids of 1,
          2 (the plan's) and 4 blocks an SM
  taa     g2 (taa0) and g3 (taa1) on the probe's draws (T 298, P 512)
          with taa_plan's split, and beside it on whole tiles a block
          (2 x SMs blocks), one block per tile (T blocks), and 1 and 4
          blocks an SM on the plan's units (the plan: 2); the plan's
          chain again with each launch on the next of 12 copies of the
          indices (59 MB, more than L2 holds: cold reads); also the
          plan's summary and the kernel's registers and resident blocks

Every launch is held to its plain version (1e-5 of max|plain|; g2 and g3
bit for bit). Times are medians of 20 launches (CUDA events), g2's and
g3's also chain_ms (200 launches back to back, bench/timing.py), beside
the card's name and power limit as nvidia-smi prints them.

    python -m maxwell_tpu_torch.bench.profile_shift_gather [--out PATH]

Runs on the card only (it times); writes JSON to --out (default
build/maxwell_tpu_torch/probes/profile_shift_gather.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import subprocess

import numpy as np
import torch

from maxwell_tpu_torch.bench import exp_gather, exp_stencil2
from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write
from maxwell_tpu_torch.bench.timing import chain_ms, median_ms
from maxwell_tpu_torch.kernels import gather_probes as gpr
from maxwell_tpu_torch.kernels import stencil_probes as sp

TOL = 1e-5  # of max|plain|
CHUNKS = (1, 2, 3, 6)
COLD = 12  # copies of g2's / g3's indices, 59 MB at T 298: past L2
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


def _taa(kind, t, T, P, sms) -> dict:
    """g2's ("taa0") or g3's ("taa1") kernel with taa_plan's split and the
    others, each held to its plain version bit for bit."""
    if kind == "taa0":
        idx, src = t["idx0"], t["X"]
        want = gpr.taa0_plain(idx, src, P)
    else:
        idx, src = t["idx1"], t["XT"]
        want = gpr.taa1_plain(idx, src)
    plan = gpr.taa_plan(kind, T, P, sms)
    tile = plan.tile_rows
    plans = {"plan": plan,
             "whole_tiles": dataclasses.replace(
                 plan, unit_rows=tile, grid=min(gpr.TAA_BLOCKS * sms, T)),
             "block_per_tile": dataclasses.replace(plan, unit_rows=tile,
                                                   grid=T),
             **{f"blocks_{k}x": dataclasses.replace(
                 plan, grid=min(k * sms, plan.units)) for k in (1, 4)}}
    row = {**plan.summary(), **gpr.taa_shape(plan)}
    Y = torch.empty_like(want)
    for name, pl in plans.items():
        Y.fill_(float("nan"))
        gpr.run_taa(pl, idx, src, Y)
        if not torch.equal(Y, want):
            raise AssertionError(f"{kind} {name}: not the plain version")

        def launch():
            gpr.run_taa(pl, idx, src, Y)

        row[f"{name}_ms"] = median_ms(launch)
        row[f"{name}_chain_ms"] = chain_ms(launch)
    # the plan's chain with the indices cold: each launch reads the next of
    # COLD copies of idx, together more than the 50 MB L2
    copies = itertools.cycle([idx.clone() for _ in range(COLD)])
    row["plan_cold_chain_ms"] = chain_ms(
        lambda: gpr.run_taa(plan, next(copies), src, Y))
    row["cold_index_bytes"] = COLD * idx.numel() * 4
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
    t = {k: torch.from_numpy(d[k]).to(dev) for k in ("X", "idx0", "idx1")}
    t["XT"] = t["X"].T.contiguous()
    T, P = exp_gather.T_REF, exp_gather.S_REF * gpr.B
    for name, kind in (("g2", "taa0"), ("g3", "taa1")):
        out[name] = _taa(kind, t, T, P, sms)
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
