"""Weak and strong scaling of the slab-sharded matrix-free pencil on P
processes: the port's counterpart of maxwell_tpu/bench/scaling.py (run,
:34).

The workload is the reference's: the vacuum PEC brick as a
DistStencilPencil3D in f32, one slab a process (D = P, dist/procs.py),
each row timing the sharded fused KM apply (m 8, the apply plus the sum of
its two outputs, 2 warm-up and 8 timed calls) and the full lobpcg_dist
solve (spectral preconditioner, alpha 15, tol 1e-30 so every row runs
`maxiter` iterations). Weak mode grows the x cells with the process count
(`cells` a slab); strong mode fixes the grid at `cells` times the largest
count. Rows carry the reference's keys (devices = processes = slabs,
efficiency against the first row), the mesh's real `hosts` and
`dcn_links` (dist/mesh.py mesh_topology_report), what each rank's link
moved (comm_model.link_volumes, per KM apply and per solve: to its
neighbours on its host and across hosts) and `shared_card`:
true where the processes share one card, time-sliced (more ranks than
cards), the counterpart of the reference's `simulated` (its CPU mesh),
which the report keeps for a CPU run. Weak mode adds the reference's
prediction rows (comm_model.CommModel seeded with the first row's time
per iteration), at the all-gather rate this transport measured in the
largest multi-process row (bytes gathered over the seconds in the gathers)
for both link classes, or at the model's default rates if there is none
(`model_bandwidth` says which).

    python -m maxwell_tpu_torch.bench.scaling [--mode weak|strong]
        [--cells 8] [--ny 16] [--nz 16] [--nev 4] [--maxiter 40]
        [--procs 1 2 4 8] [--device cuda|cpu] [--out PATH]

On more than one host, each host's launcher calls scaling_row through
dist.procs.spawn with its Rendezvous; the row carries the mesh's hosts.

Process counts above the host's CPU count are left out, and on a card in
Exclusive_Process mode so are counts above its card count. Runs on the
card unless --device cpu is given. Writes JSON to --out (default
build/maxwell_tpu_torch/probes/scaling_<mode>_results.json), never to the
reference's root scaling_results.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from maxwell_tpu_torch.bench.comm_model import CommModel, link_volumes
from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write

APPLY_M = 8  # the reference's KM apply width


def compute_mode() -> str:
    """The card's compute mode as nvidia-smi prints it ("Default" lets
    several processes' contexts share it)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _timeit(fn, sync, iters=8, warmup=2):
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        sync()
    return (time.perf_counter() - t0) / iters


def scaling_row(nx: int, ny: int, nz: int, procs: int, nev: int,
                maxiter: int, device="cuda", X0=None) -> dict:
    """One row on this process's slab of a mesh of `procs` slabs over
    `procs` processes (called in each rank of a spawn when procs > 1);
    rank 0's row is returned, with the link's volumes of every rank and
    the solve's residual history (`history`: the max relative residual of
    each iteration). X0: the solve's start block, a host array in the
    stacked layout (default: the pencil's make_block)."""
    from maxwell_tpu_torch.dist import make_mesh, mesh_topology_report
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
    from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist

    mesh = make_mesh(procs, device_of(device), procs)
    dev = mesh.device
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    sp = DistStencilPencil3D.build(nx=nx, ny=ny, nz=nz, D=procs,
                                   dtype=torch.float32, mesh=mesh)
    topo = mesh_topology_report(mesh)
    X = sp.make_block(APPLY_M)
    v0 = link_volumes(sp.link)
    t_apply = _timeit(lambda: (lambda a, b: a + b)(*sp.KM_mm(X)), sync)
    v1 = link_volumes(sp.link)
    sync()
    t0 = time.perf_counter()
    res = lobpcg_dist(sp, mesh, nev=nev, maxiter=maxiter, tol=1e-30,
                      precond_alpha=15.0, X0=X0)
    sync()
    t_solve = time.perf_counter() - t0
    v2 = link_volumes(sp.link)
    iters = max(int(res.iterations), 1)
    applies = 10  # _timeit's warm-up and timed calls
    mine = {
        "km_apply_bytes_pushed": (v1["bytes_pushed"] - v0["bytes_pushed"])
        // applies,
        "km_apply_bytes_across_hosts": (v1["bytes_across_hosts"]
                                        - v0["bytes_across_hosts"])
        // applies,
        "km_apply_host_s": (v1["host_s"] - v0["host_s"]) / applies,
        "km_apply_wait_s": (v1["wait_s"] - v0["wait_s"]) / applies,
        "solve_bytes_pushed_per_iter":
            (v2["bytes_pushed"] - v1["bytes_pushed"]) / iters,
        "solve_gathers_per_iter": (v2["gathers"] - v1["gathers"]) / iters,
        "solve_bytes_gathered_per_iter":
            (v2["bytes_gathered"] - v1["bytes_gathered"]) / iters,
        "solve_wait_s": v2["wait_s"] - v1["wait_s"],
        "solve_gather_s": v2["gather_s"] - v1["gather_s"],
    }
    every = ([mine] if sp.link is None
             else sp.link.group.all_gather_object(mine))
    sp.close()
    n = sp.n_full
    nnz_eff = 33 * n  # an assembled curl-curl row holds ~33 nonzeros
    return {
        "devices": procs,
        "grid": [nx, ny, nz],
        "n": n,
        "nnz_eff": nnz_eff,
        "t_km_apply_s": t_apply,
        "nnz_per_s": 2 * nnz_eff / t_apply,  # KM = two operators
        "t_solve_s": t_solve,
        "t_iter_s": t_solve / iters,
        "solve_iters": int(res.iterations),
        "max_res": float(res.residuals.max()),
        "history": [h["max_rel_res"] for h in res.history],
        "dcn_links": topo["dcn_links"],
        "hosts": topo["hosts"],
        "procs": procs,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        **{f"{k}_per_rank": [e[k] for e in every] for k in mine},
    }


def run(mode: str = "weak", cells: int = 8, ny: int = 16, nz: int = 16,
        nev: int = 4, maxiter: int = 40, procs=(1, 2, 4, 8),
        device="cuda", out=None) -> dict:
    """The scaling rows over the process counts `procs` that the host can
    start; writes the report to `out` (see the module docstring) and
    returns it."""
    from maxwell_tpu_torch.dist.procs import spawn

    if mode not in ("weak", "strong"):
        raise ValueError(f"mode must be weak or strong, got {mode!r}")
    dev = device_of(device)
    mode_of_card = compute_mode() if dev.type == "cuda" else None
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    sizes = [p for p in procs if p <= (os.cpu_count() or 1) and not (
        mode_of_card == "Exclusive_Process" and p > cards)]
    if not sizes:
        raise ValueError(f"no process count of {procs} can start here")
    rows = []
    for P in sizes:
        nx = cells * P if mode == "weak" else cells * max(sizes)
        args = (nx, ny, nz, P, nev, maxiter, device)
        row = (spawn(scaling_row, P, *args, device=device) if P > 1
               else scaling_row(*args))
        row["shared_card"] = dev.type == "cuda" and P > cards
        r0 = rows[0] if rows else row
        if mode == "weak":
            row["efficiency"] = r0["t_km_apply_s"] / row["t_km_apply_s"]
        else:
            row["efficiency"] = r0["t_km_apply_s"] / (
                row["t_km_apply_s"] * P / sizes[0])
        rows.append(row)
        print(json.dumps(row), flush=True)
    predicted = bandwidth = None
    if mode == "weak":
        r0 = rows[0]
        multi = [r for r in rows if r["procs"] > 1]
        kw, bandwidth = {}, {"source": "the model's default rates"}
        if multi and multi[-1]["solve_gather_s_per_rank"][0] > 0:
            r = multi[-1]
            rate = (r["solve_bytes_gathered_per_iter_per_rank"][0]
                    * r["solve_iters"] / r["solve_gather_s_per_rank"][0])
            kw = {"bw_ici": rate, "bw_dcn": rate}
            bandwidth = {"source": f"measured: rank 0's all-gathers at "
                                   f"{r['procs']} processes",
                         "B_per_s": rate}
        cm = CommModel(ny=ny, nz=nz, cells=cells, m=nev + max(4, nev // 2),
                       t_compute_iter_s=r0["t_solve_s"]
                       / max(r0["solve_iters"], 1), **kw)
        predicted = cm.report(sizes=tuple(sorted(
            {r["devices"] for r in rows} | {8, 16, 32, 64})))
    report = {
        "mode": mode,
        "simulated": dev.type == "cpu",
        "shared_card": any(r["shared_card"] for r in rows),
        "compute_mode": mode_of_card,
        "platform": dev.type,
        "workload": "DistStencilPencil3D LOBPCG (slab-sharded, "
                    "assembly-free taps), one slab a process",
        "rows": rows,
        "predicted_weak_scaling": predicted,
        "model_bandwidth": bandwidth,
    }
    path = write(report, out or PROBE_DIR / f"scaling_{mode}_results.json")
    report["path"] = str(path)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="weak", choices=("weak", "strong"))
    ap.add_argument("--cells", type=int, default=8)
    ap.add_argument("--ny", type=int, default=16)
    ap.add_argument("--nz", type=int, default=16)
    ap.add_argument("--nev", type=int, default=4)
    ap.add_argument("--maxiter", type=int, default=40)
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    report = run(args.mode, args.cells, args.ny, args.nz, args.nev,
                 args.maxiter, tuple(args.procs), args.device, args.out)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
