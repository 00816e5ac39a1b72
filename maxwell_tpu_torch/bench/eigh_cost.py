"""What the f64 small eigh (solvers/rr.small_eigh) costs two short f32
solves, against the f32 eigh it replaced, in one process: the 24^3 RCM
brick through solve(kernel="bellpairs") (nev 5, tol 1e-5, maxiter 120,
stall_window 12, a seeded X0, no refine) and config 4 through the CLI with
storage {"dtype": "f32", "kernel": "union"} and host refine (t_solve_s is
the device solve alone). The two modes alternate f64, f32, f32, f64 per
round, so that a drift of the host clock falls on both:

  f64   small_eigh as the port runs it (float64 on the tensor's device)
  f32   torch.linalg.eigh on the matrix as given, in its own dtype: the
        eigh before small_eigh existed

Per run: iterations, solve seconds, whether it converged, the number of
small eigh calls and their summed host time (the device synchronised
before and after each call; torch.linalg.eigh waits for its own result on
a CUDA device, so the wait moves and is not added). Per case and mode: the
median, least and largest of each. The process's first run also pays the
first f64 eigh's setup on the card (tens of ms): read the medians.

    python -m maxwell_tpu_torch.bench.eigh_cost [--out PATH]

Runs on the card (none visible: it raises). Writes JSON to --out (default
build/maxwell_tpu_torch/probes/eigh_cost.json).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write

CONFIG4 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "configs", "config4.json")
ORDER = ("f64", "f32", "f32", "f64")  # one round
ROUNDS = 3


@contextlib.contextmanager
def eigh_mode(mode: str, log: list):
    """LOBPCG's small eigh at its three sites (rr.eigh_gen, rr.svqb, the
    Rayleigh-Ritz step of lobpcg_run) run as `mode` says ("f64":
    small_eigh, "f32": torch.linalg.eigh as before it), each call's host
    seconds appended to `log`."""
    from maxwell_tpu_torch.solvers import rr

    if mode not in ("f64", "f32"):
        raise ValueError(f"mode must be 'f64' or 'f32', got {mode!r}")
    lobpcg = importlib.import_module("maxwell_tpu_torch.solvers.lobpcg")
    small = rr.small_eigh
    base = small if mode == "f64" else torch.linalg.eigh

    def eigh(A):
        sync = A.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(A.device)
        t0 = time.perf_counter()
        out = base(A)
        if sync:
            torch.cuda.synchronize(A.device)
        log.append(time.perf_counter() - t0)
        return out

    rr.small_eigh = lobpcg.small_eigh = eigh
    try:
        yield
    finally:
        rr.small_eigh = lobpcg.small_eigh = small


def bellpairs_solve(device):
    """A function running the 24^3 bellpairs solve; returns (iterations,
    device solve s, converged)."""
    import maxwell_tpu_torch
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    problem = PermutedProblem(BrickCavity3D(nx=24, ny=24, nz=24))
    X0 = np.random.default_rng(5).standard_normal((problem.K.shape[0], 9))

    def solve():
        res = maxwell_tpu_torch.solve(
            problem, kernel="bellpairs", dtype=torch.float32, device=device,
            nev=5, tol=1e-5, refine=False, maxiter=120, stall_window=12,
            X0=X0)
        return (res.iterations, res.timings["device_solve_s"],
                bool(res.converged))

    return solve


def config4_solve(device, tmp):
    """A function running config 4 (f32 union, refined) through the CLI;
    returns (iterations, t_solve_s, converged)."""
    from maxwell_tpu_torch.cli import run as cli

    with open(CONFIG4) as f:
        cfg = json.load(f)
    cfg["storage"] = {"dtype": "f32", "kernel": "union"}
    cfg["solver"]["refine"] = True
    path = os.path.join(tmp, "config4_f32_union.json")
    with open(path, "w") as f:
        json.dump(cfg, f)

    def solve():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main([path, "--device", str(device.type)])
        rep = json.loads(out.getvalue().strip().splitlines()[-1])
        return rep["iterations"], rep["t_solve_s"], rc == 0 and bool(
            rep["converged"])

    return solve


def measure(solve, rounds: int) -> dict:
    """solve() under each mode of ORDER, `rounds` times; the runs and, per
    mode, their medians and ranges."""
    runs = []
    for _ in range(rounds):
        for mode in ORDER:
            log = []
            with eigh_mode(mode, log):
                it, secs, ok = solve()
            runs.append({"mode": mode, "iterations": it, "solve_s": secs,
                         "converged": ok, "eigh_calls": len(log),
                         "eigh_ms": sum(log) * 1e3})
    summary = {}
    for mode in ORDER[:2]:
        mine = [r for r in runs if r["mode"] == mode]
        summary[mode] = {
            key: {"median": statistics.median(r[key] for r in mine),
                  "min": min(r[key] for r in mine),
                  "max": max(r[key] for r in mine)}
            for key in ("iterations", "solve_s", "eigh_calls", "eigh_ms")}
        summary[mode]["all_converged"] = all(r["converged"] for r in mine)
    return {"runs": runs, "summary": summary}


def run() -> dict:
    dev = device_of("cuda")
    results = {"device": torch.cuda.get_device_name(dev), "rounds": ROUNDS,
               "order": ORDER}
    results["bellpairs_24"] = measure(bellpairs_solve(dev), ROUNDS)
    with tempfile.TemporaryDirectory() as tmp:
        results["config4_f32"] = measure(config4_solve(dev, tmp), ROUNDS)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(PROBE_DIR / "eigh_cost.json"))
    args = ap.parse_args(argv)
    results = run()
    write(results, args.out)
    print(json.dumps({case: results[case]["summary"]
                      for case in ("bellpairs_24", "config4_f32")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
