"""Where the K15d gathers' time goes, on the card, at the probe's T 298 and
3 live chunks (exp_grid.py):

  e3      gather_sum's grid at 1, 2 (the plan's) and 4 blocks an SM
  slices  e4 and e5 with their plan's launch on three placements of the
          same slice bytes, timed side by side: `probe`, the probe's own
          scattered columns; `own`, every slot of block row r on the row's
          own slice X[8 r : 8 r + 16] (in order over X); `one`, every slot
          of every row on the slice X[0:16]

e4, e5 and e3 launch through the wrappers' uncounted launch functions
(grid_probes.run_rows, gather_probes.run_plan).

Every launch is held to its plain version (1e-5 of max|plain|). Times are
medians of 20 launches (CUDA events), beside the card's name and power
limit as nvidia-smi prints them.

    python -m maxwell_tpu_torch.bench.profile_grid [--out PATH]

Runs on the card only (it times); writes JSON to --out (default
build/maxwell_tpu_torch/probes/profile_grid.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

from maxwell_tpu_torch.bench import exp_grid
from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write
from maxwell_tpu_torch.bench.timing import median_ms
from maxwell_tpu_torch.kernels import gather_probes as gpr
from maxwell_tpu_torch.kernels import grid_probes as gp

TOL = 1e-5  # of max|plain|


def _held(label, got, want) -> None:
    err = ((got - want).abs().max() / want.abs().max()).item()
    if not err <= TOL:
        raise AssertionError(f"{label}: relative error {err:.3e}")


def _acc(cols, X, sms) -> dict:
    """e3's gather_sum on grids of 1, 2 (the plan's) and 4 blocks an SM."""
    want = gp.acc_plain(cols, X, exp_grid.LIVE)
    plan = gp.acc_plan(cols, exp_grid.LIVE, sms)
    Y = torch.empty_like(want)
    row = {"plan_grid": plan.grid}
    for k in (1, 2, 4):
        pl = dataclasses.replace(plan, grid=min(k * sms, plan.groups))
        gpr.run_plan(pl, cols, X, Y)
        _held(f"e3 grid {pl.grid}", Y, want)
        row[f"grid_{k}x_ms"] = median_ms(lambda: gpr.run_plan(pl, cols, X, Y))
    return row


def _slices(cols, X, vals, sms) -> dict:
    """e4 and e5 with the plan's launch on the probe's columns, on each
    row's own slice and on one slice for all."""
    live = exp_grid.LIVE
    own = torch.arange(cols.shape[0], dtype=torch.int32,
                       device=cols.device)[:, None].expand_as(cols)
    placements = {"probe": cols, "own": own.contiguous(),
                  "one": torch.zeros_like(cols)}
    row = {}
    for kind, name in (("cat", "e4"), ("cat_mm", "e5")):
        plan = gp.row_plan(cols.shape[0], live, sms, kind)
        v = vals if kind == "cat_mm" else None
        for where, c in placements.items():
            want = (gp.cat_plain(c, X, live) if v is None
                    else gp.cat_mm_plain(c, v, X, live))
            _held(f"{name} {where}", gp.run_rows(plan, c, X, v), want)
            row[f"{name}_{where}_ms"] = median_ms(
                lambda: gp.run_rows(plan, c, X, v))
    return row


def run(device="cuda") -> dict:
    dev = device_of(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_grid times kernels: it needs the card")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d = exp_grid.make_inputs(exp_grid.T_REF)
    cols, X, vals = (torch.from_numpy(d[k]).to(dev)
                     for k in ("cols", "X", "vals"))
    return {"device": torch.cuda.get_device_name(dev), "sms": sms,
            "T": exp_grid.T_REF, "live": exp_grid.LIVE,
            "e3": _acc(cols, X, sms),
            "slices": _slices(cols, X, vals, sms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(PROBE_DIR / "profile_grid.json"))
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
