"""CLI driver: `python -m maxwell_tpu_torch.cli.run configs/config2.json
[--device cuda|cpu] [overrides]`.

Takes the JSON configs of maxwell_tpu/cli/run.py (configs/); this port runs
the solver kinds "lobpcg", "lanczos", "tr_lanczos" (`ncv`, `max_restarts`)
and "shift_invert" (`sigma`; K - sigma M factored on the host from the
assembled matrices, config 3) on the assembled "rect2d", "brick3d" and
"tet3d" problems (`storage.kernel`: "auto", "ref", "union", "pallas" or
"bellpairs"; tet3d: a Kuhn-triangulated brick of `n` cubes a side, its
interior vertices moved by `jiggle` * h normal draws from `seed`, config 6)
and on
the matrix-free operator (`storage.operator == "stencil"`: StencilPencil2D
/ StencilPencil3D, with materials), and "lobpcg_dist" on the assembled
problems (`dist.n_shards` row shards, `storage.kernel` "auto", "ref",
"union" or "pallas"; config 4) and on the slab-sharded matrix-free operator
(`storage.operator == "stencil"`, brick3d only: DistStencilPencil3D with
the distributed spectral preconditioner; configs 4_stencil and 5). A
distributed run builds the mesh its config names, all shards on the one
device: the reference clamps the shard count to the visible devices, since
a JAX mesh needs a device per shard. `--procs P` runs "lobpcg_dist" on P
processes (dist/procs.py), D / P shards or slabs each, rank r on
cuda:(r % device count) (or the CPU with --device cpu): the assembled
road (config 4) and the slab-sharded one (configs 4_stencil and 5, whose
refinement, `refine_dw_dist`, every rank runs); rank 0's history and
report are printed, by this process. `--checkpoint f.npz` and
`--checkpoint-every k` work there as in one process: the ranks write the
D shard files `f.npz.shard{d}` every k iterations, rank 0 the exit-time
file, and a run resumes from them at another P (the exit-time file also
at another shard count), its history starting at the saved iteration.
Across H hosts each host runs the same command with `--hosts H --host h
--rendezvous ADDR:PORT` (host 0's address, a free port there) and its own
h: `--procs P` ranks a host, ranks hosts-major, D / (H P) shards or slabs
each (dist/procs.py Rendezvous); host 0 prints rank 0's history and
report, the other hosts print nothing.
The other solver kinds take one process; shift-invert across processes
is reached through the solvers (`shift_invert_lanczos_dist`,
`thick_restart_lanczos_dist(mode="shift_invert")`), as in the
reference, whose CLI has no distributed shift-invert kind. With
refinement, PEC 3D stencil
pencils refine to tol on the device (`refine_dw`; slab-sharded ones
`refine_dw_dist`, for a staged `batch` run each stage's block before it
joins the deflation basis), other stencil pencils by warm-started f64
LOBPCG on the CPU (`refine_f64_pencil`), and assembled problems by host f64
RQI (`refine_f64`). A shift-invert on the matrix-free operator raises the
reference's ValueError (the factorization needs assembled matrices).

Prints the per-iteration history as JSON lines, then a final JSON report
(eigenvalues, residuals, iterations, converged, timings, n, and the
analytic oracle for vacuum PEC cavities) with the reference CLI's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def material_grids(cfg):
    """Per-cell eps_r/mu_r from the JSON "materials" block:

      "materials": {"eps_fill": {"value": 2.5,
                                 "box": [x0, x1, y0, y1, z0, z1]},
                    "mu_fill":  {...}}

    box is in fractional cell coordinates (default: the whole cavity).
    Returns (eps_r, mu_r) numpy grids or (None, None).
    """
    import numpy as np

    mcfg = cfg.get("materials")
    if not mcfg:
        return None, None
    nx, ny, nz = cfg.get("nx", 8), cfg.get("ny", 8), cfg.get("nz", 8)

    def grid(spec):
        if spec is None:
            return None
        g = np.ones((nx, ny, nz))
        box = spec.get("box", [0, 1, 0, 1, 0, 1])
        i0, i1 = int(box[0] * nx), max(int(box[1] * nx), int(box[0] * nx) + 1)
        j0, j1 = int(box[2] * ny), max(int(box[3] * ny), int(box[2] * ny) + 1)
        k0, k1 = int(box[4] * nz), max(int(box[5] * nz), int(box[4] * nz) + 1)
        g[i0:i1, j0:j1, k0:k1] = spec.get("value", 1.0)
        return g

    return grid(mcfg.get("eps_fill")), grid(mcfg.get("mu_fill"))


def build_problem(cfg):
    kind = cfg.get("kind", "rect2d")
    if kind == "rect2d":
        from maxwell_tpu_torch.problems import RectCavity2D

        return RectCavity2D(
            a=cfg.get("a", 1.0),
            b=cfg.get("b", 1.0),
            nx=cfg.get("nx", 16),
            ny=cfg.get("ny", 16),
            bc=cfg.get("bc", "pec"),
        )
    if kind == "brick3d":
        from maxwell_tpu_torch.problems import BrickCavity3D

        eps_r, mu_r = material_grids(cfg)
        return BrickCavity3D(
            a=cfg.get("a", 1.0),
            b=cfg.get("b", 1.0),
            c=cfg.get("c", 1.0),
            nx=cfg.get("nx", 8),
            ny=cfg.get("ny", 8),
            nz=cfg.get("nz", 8),
            bc=cfg.get("bc", "pec"),
            eps_r=eps_r,
            mu_r=mu_r,
        )
    if kind == "tet3d":
        # unstructured tetrahedral Nedelec on a Kuhn-triangulated brick;
        # "jiggle" moves the interior vertices so the mesh is not a tensor
        # product (the reference CLI's mesh, the same draws)
        import numpy as np

        from maxwell_tpu_torch.problems.tetmesh import (
            TetCavity,
            brick_tet_mesh,
        )

        a, b, c = cfg.get("a", 1.0), cfg.get("b", 1.0), cfg.get("c", 1.0)
        n = cfg.get("n", cfg.get("nx", 6))
        jig = cfg.get("jiggle", 0.0)
        if jig:
            verts, tets = brick_tet_mesh(a, b, c, n, n, n)
            rng = np.random.default_rng(cfg.get("seed", 0))
            eps = 1e-9
            interior = np.all(
                (verts > eps) & (verts < np.array([a, b, c]) - eps), axis=1
            )
            verts = verts.copy()
            verts[interior] += (
                jig * (a / n) * rng.standard_normal((int(interior.sum()), 3))
            )
            return TetCavity(a=a, b=b, c=c, verts=verts, tets=tets)
        return TetCavity(a=a, b=b, c=c, n=n)
    raise ValueError(f"unknown problem kind {kind!r}")


def build_stencil(pcfg, dtype, block, device):
    """The matrix-free pencil of a "rect2d" or "brick3d" problem block."""
    if pcfg.get("kind", "rect2d") == "rect2d":
        from maxwell_tpu_torch.problems.stencil2d import StencilPencil2D

        return StencilPencil2D.build(
            a=pcfg.get("a", 1.0), b=pcfg.get("b", 1.0),
            nx=pcfg.get("nx", 16), ny=pcfg.get("ny", 16),
            dtype=dtype, block=block or 8, bc=pcfg.get("bc", "pec"),
            device=device,
        )
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D

    eps_r, mu_r = material_grids(pcfg)
    return StencilPencil3D.build(
        a=pcfg.get("a", 1.0), b=pcfg.get("b", 1.0), c=pcfg.get("c", 1.0),
        nx=pcfg.get("nx", 8), ny=pcfg.get("ny", 8), nz=pcfg.get("nz", 8),
        dtype=dtype, block=block or 8, bc=pcfg.get("bc", "pec"),
        eps_r=eps_r, mu_r=mu_r, device=device,
    )


def _lobpcg(pencil, scfg, nev, maxiter, tol, args, stall_window):
    """LOBPCG with the config's preconditioner: the spectral
    (K + alpha M)^-1 for PEC 3D stencil pencils where `precond` allows it,
    else shifted CG."""
    from maxwell_tpu_torch.solvers import lobpcg
    from maxwell_tpu_torch.solvers.precond import shifted_cg_preconditioner
    from maxwell_tpu_torch.solvers.spectral import spectral_preconditioner

    pc = None
    if scfg.get("precond_alpha") is not None:
        pkind = scfg.get("precond", "auto")
        if pkind in ("auto", "spectral"):
            try:
                pc = spectral_preconditioner(
                    pencil, alpha=scfg["precond_alpha"]
                )
            except (ValueError, AttributeError):
                if pkind == "spectral":
                    raise
        if pc is None:
            pc = shifted_cg_preconditioner(
                pencil,
                alpha=scfg["precond_alpha"],
                iters=scfg.get("precond_iters", 20),
            )
    return lobpcg(
        pencil,
        nev=nev,
        m=scfg.get("block_size"),
        maxiter=maxiter,
        tol=tol,
        precond=pc,
        checkpoint=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        log_every=scfg.get("log_every", 0),
        stall_window=stall_window,
    )


def build_dist_stencil(pcfg, mesh, dtype, block):
    """The slab-sharded matrix-free pencil of a "brick3d" problem block on
    the mesh (vacuum: the CLI passes no materials, as the reference's
    does): mesh.D slabs, this process's on its device."""
    if pcfg.get("kind") != "brick3d":
        raise ValueError("distributed stencil operator is 3D-only")
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D

    return DistStencilPencil3D.build(
        a=pcfg.get("a", 1.0), b=pcfg.get("b", 1.0), c_len=pcfg.get("c", 1.0),
        nx=pcfg.get("nx", 8), ny=pcfg.get("ny", 8), nz=pcfg.get("nz", 8),
        D=mesh.D, dtype=dtype, block=block or 8, mesh=mesh,
    )


def _lobpcg_dist(dp, mesh, scfg, dtype, nev, maxiter, tol, full_tol, args,
                 want_refine):
    """The distributed LOBPCG of the reference CLI (maxwell_tpu/cli/run.py:
    213-291) on a row-sharded or slab-sharded pencil, and an f32 solve that
    a refinement follows cut at its floor (stall_window 15). A staged run
    (`batch` < nev) of a vacuum slab-sharded pencil with refinement polishes
    each stage's block to full_tol (`refine_dw_dist`) before it joins the
    deflation basis. Returns (result, polished): polished is True when the
    stages were refined, so no final refinement is needed. The reference
    also skips the final refinement when the hook exists but no stage ran
    (batch >= nev); here that run is refined at the end."""
    import torch

    from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist

    batch = scfg.get("batch")
    stage_polish = None
    if (want_refine and batch is not None and batch < nev
            and getattr(dp, "taps_dw", None) is not None):
        from maxwell_tpu_torch.solvers.refine_device import refine_dw_dist

        def stage_polish(r):
            return refine_dw_dist(dp, mesh, r.eigenvectors, tol=full_tol)

    res = lobpcg_dist(
        dp, mesh, nev=nev, m=scfg.get("block_size"), maxiter=maxiter,
        tol=tol, precond_alpha=scfg.get("precond_alpha"),
        precond_iters=scfg.get("precond_iters", 20),
        precond=scfg.get("precond", "auto"), checkpoint=args.checkpoint,
        checkpoint_every=args.checkpoint_every, batch=batch,
        stall_window=scfg.get(
            "stall_window",
            15 if want_refine and dtype == torch.float32 else 0,
        ),
        stage_polish=stage_polish,
        log_every=scfg.get("log_every", 0),
    )
    return res, stage_polish is not None


def _single_device(pencil, kind, scfg, nev, maxiter, tol, args, f32_refine,
                   problem):
    """The config's solver on one pencil (`problem`: the assembled problem,
    None for the matrix-free operator)."""
    if kind == "shift_invert":
        from maxwell_tpu_torch.solvers.shift_invert import (
            shift_invert_lanczos,
        )

        return shift_invert_lanczos(
            pencil, sigma=scfg.get("sigma", 1.0), nev=nev, maxiter=maxiter,
            tol=tol, KM=(problem.K, problem.M),  # the assembled matrices
        )
    if kind == "lanczos":
        from maxwell_tpu_torch.solvers.lanczos import lanczos

        return lanczos(pencil, nev=nev, maxiter=maxiter, tol=tol)
    if kind == "tr_lanczos":
        from maxwell_tpu_torch.solvers.trlanczos import thick_restart_lanczos

        return thick_restart_lanczos(
            pencil, nev=nev, ncv=scfg.get("ncv"),
            max_restarts=scfg.get("max_restarts", 40), tol=tol,
        )
    # an f32 solve that a refinement follows is cut at the f32 floor and
    # hands over its best iterate (the reference CLI's rule for its
    # distributed LOBPCG, maxwell_tpu/cli/run.py:274-285, applied here to
    # every LOBPCG): bouncing on at the floor can break the block down
    # (config 2 at f32: max residual 0.99 by iteration 67), and the refine
    # then converges to other eigenpairs
    stall = 15 if f32_refine else 0
    return _lobpcg(pencil, scfg, nev, maxiter, tol, args, stall)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", help="path to JSON config")
    ap.add_argument("--nev", type=int, default=None)
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--maxiter", type=int, default=None)
    ap.add_argument("--checkpoint", default=None, help="state file for save/resume")
    ap.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="also save the Ritz block every K iterations",
    )
    ap.add_argument(
        "--save-eigenvectors", default=None,
        help="write eigenpairs (values + vectors) to this .npz",
    )
    ap.add_argument(
        "--refine", action="store_true",
        help="polish to tol after the f32 solve: on the device for PEC 3D "
        "stencil pencils, in f64 on the host otherwise",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device of the solve (default: cuda)",
    )
    ap.add_argument(
        "--procs", type=int, default=1,
        help="processes of a lobpcg_dist run, assembled or slab-sharded, "
        "--checkpoint included (default: 1); across hosts, a host's",
    )
    ap.add_argument(
        "--hosts", type=int, default=1,
        help="hosts of a lobpcg_dist run, each running this command with "
        "its --host (default: 1)",
    )
    ap.add_argument("--host", type=int, default=0,
                    help="this host's index among --hosts (default: 0)")
    ap.add_argument(
        "--rendezvous", default=None,
        help="ADDR:PORT where host 0's launcher holds the ranks' store "
        "(with --hosts > 1)",
    )
    return ap


def main(argv=None):
    """Run the config (on --procs processes) and print its history lines
    and report."""
    from maxwell_tpu_torch.dist import procs

    args = _parser().parse_args(argv)
    if args.procs > 1 or args.hosts > 1:
        with open(args.config) as f:
            cfg = json.load(f)
        if cfg.get("solver", {}).get("kind") != "lobpcg_dist":
            raise ValueError(
                "--procs > 1 runs lobpcg_dist (configs 4, 4_stencil and 5) "
                "only; the one-device solvers take one process")
        from maxwell_tpu_torch.dist import rank_tasks

        rendezvous = None
        if args.hosts > 1:
            if args.rendezvous is None:
                raise ValueError("--hosts > 1 needs --rendezvous ADDR:PORT")
            addr, _, port = args.rendezvous.rpartition(":")
            rendezvous = procs.Rendezvous(addr, int(port), args.hosts,
                                          args.host)
        history, report = procs.spawn(rank_tasks.cli, args.procs,
                                      list(argv or sys.argv[1:]),
                                      device=args.device,
                                      rendezvous=rendezvous)
        if args.host != 0:
            return 0
    else:
        history, report = run(argv)
    for h in history:
        print(json.dumps(h))
    print(json.dumps(report))
    return 0


def run(argv=None):
    """The config's solve on this process: (history, report). Inside a rank
    of a spawn the mesh spans --procs processes; the slab-sharded
    refinement is a collective every rank runs, the host refinements run
    on rank 0 only."""
    import torch

    from maxwell_tpu_torch.dist import procs

    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    group = procs.current()
    rank = 0 if group is None else group.rank
    if group is not None:
        device = group.device

    with open(args.config) as f:
        cfg = json.load(f)
    scfg = cfg.get("solver", {})
    if args.nev is not None:
        scfg["nev"] = args.nev
    if args.tol is not None:
        scfg["tol"] = args.tol
    if args.maxiter is not None:
        scfg["maxiter"] = args.maxiter

    kind = scfg.get("kind", "lobpcg")
    stg = cfg.get("storage", {})
    pcfg = cfg.get("problem", {})
    if kind not in ("lobpcg", "lanczos", "tr_lanczos", "shift_invert",
                    "lobpcg_dist"):
        raise ValueError(f"unknown solver {kind!r}")
    use_stencil = stg.get("operator") == "stencil"
    if kind == "shift_invert" and use_stencil:
        raise ValueError(
            "shift_invert needs assembled matrices (factorization); "
            "drop storage.operator=stencil"
        )
    dtype = {"f32": torch.float32, "f64": torch.float64}[
        stg.get("dtype", "f64")
    ]
    block = stg.get("block")  # None -> per-kernel default layout
    kernel = stg.get("kernel", "auto")
    if kernel == "auto":
        kernel = (
            "union"
            if device.type == "cuda" and dtype == torch.float32
            else "ref"
        )

    t0 = time.perf_counter()
    # the matrix-free path builds no assembled matrices
    problem = None if use_stencil else build_problem(pcfg)
    t_setup = time.perf_counter() - t0

    nev = scfg.get("nev", 5)
    tol = scfg.get("tol", 1e-8)
    maxiter = scfg.get("maxiter", 200)
    want_refine = args.refine or scfg.get("refine", False)
    full_tol = tol
    if want_refine and dtype == torch.float32:
        # the device solve only needs the f32-comfortable part
        tol = max(tol, 1e-5)

    from maxwell_tpu_torch.solvers.operator import Pencil

    t0 = time.perf_counter()
    dp = None
    if kind == "lobpcg_dist":
        from maxwell_tpu_torch.dist import make_mesh, partition_problem

        mesh = make_mesh(cfg.get("dist", {}).get("n_shards", 1), device,
                         args.procs if group is None else group.procs)
        if use_stencil:
            dp = build_dist_stencil(pcfg, mesh, dtype, block)
        else:
            dp = partition_problem(problem, mesh.D, block=block,
                                   kernel=kernel, dtype=dtype, mesh=mesh)
        res, polished = _lobpcg_dist(dp, mesh, scfg, dtype, nev, maxiter,
                                     tol, full_tol, args, want_refine)
        if polished:
            # each stage was refined to full_tol before it was deflated
            want_refine = False
    else:
        if use_stencil:
            pencil = build_stencil(pcfg, dtype, block, device)
        else:
            pencil = Pencil.from_problem(
                problem, block=block, kernel=kernel, dtype=dtype,
                device=device,
            )
        res = _single_device(pencil, kind, scfg, nev, maxiter, tol, args,
                             want_refine and dtype == torch.float32, problem)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_solve = time.perf_counter() - t0

    t_refine = None
    # refine_dw_dist is a collective; the host refinements need one rank
    collective = kind == "lobpcg_dist" and use_stencil
    if want_refine and (rank == 0 or collective):
        from maxwell_tpu_torch.solvers.refine_device import (
            refine_dw,
            refine_dw_supports,
        )

        t0 = time.perf_counter()
        if kind == "lobpcg_dist" and use_stencil:
            # double-word RQI on the slabs (vacuum slab pencils)
            from maxwell_tpu_torch.solvers.refine_device import (
                refine_dw_dist,
            )

            ref = refine_dw_dist(dp, mesh, res.eigenvectors, tol=full_tol)
        elif use_stencil and refine_dw_supports(pencil):
            # double-word RQI on the device: PEC 3D stencil pencils, vacuum
            # (exact spectral shift solves) and loaded (block MINRES)
            ref = refine_dw(pencil, res.eigenvectors, tol=full_tol)
        elif use_stencil:
            # matrix-free polish: the same pencil, materials included, at
            # f64 on the CPU, LOBPCG continued from the f32 block
            from maxwell_tpu_torch.solvers.refine import refine_f64_pencil

            ref = refine_f64_pencil(
                lambda dt, dev: build_stencil(pcfg, dt, block, dev),
                res.eigenvectors, tol=full_tol,
                precond_alpha=scfg.get("precond_alpha", 15.0),
                precond_iters=scfg.get("precond_iters", 16),
            )
        else:
            from maxwell_tpu_torch.solvers.refine import refine_f64

            ref = refine_f64(
                problem, res.eigenvectors, theta=res.eigenvalues,
                tol=full_tol,
            )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_refine = time.perf_counter() - t0
        ref.history = list(res.history) + [
            dict(h, phase="refine") for h in ref.history
        ]
        ref.iterations += res.iterations
        res = ref

    report = {
        "eigenvalues": [float(v) for v in res.eigenvalues],
        "residuals": [float(r) for r in res.residuals],
        "iterations": res.iterations,
        "converged": res.converged,
        "t_setup_s": t_setup,
        "t_solve_s": t_solve,
        "n": int(dp.n_full if kind == "lobpcg_dist" and use_stencil
                 else pencil.n if use_stencil else problem.n_edges),
    }
    if t_refine is not None:
        report["t_refine_s"] = t_refine
    if (kind != "shift_invert" and pcfg.get("bc", "pec") == "pec"
            and not pcfg.get("materials")):
        # analytic oracle: the smallest PEC modes (none for loaded cavities,
        # nor for shift-invert, whose modes are those nearest sigma)
        if pcfg.get("kind", "rect2d") == "rect2d":
            from maxwell_tpu_torch.problems.analytic import te_eigenvalues_2d

            exact = te_eigenvalues_2d(pcfg.get("a", 1.0), pcfg.get("b", 1.0), nev)
        else:
            from maxwell_tpu_torch.problems.analytic import cavity_eigenvalues_3d

            exact = cavity_eigenvalues_3d(
                pcfg.get("a", 1.0), pcfg.get("b", 1.0), pcfg.get("c", 1.0), nev
            )
        report["analytic"] = [float(v) for v in exact]
        report["analytic_rel_err"] = [
            float(abs(v - e) / e) for v, e in zip(res.eigenvalues, exact)
        ]
    if args.save_eigenvectors and rank == 0:
        import numpy as np

        np.savez(
            args.save_eigenvectors,
            eigenvalues=res.eigenvalues,
            eigenvectors=res.eigenvectors,
            residuals=res.residuals,
        )
        report["eigenvectors_file"] = args.save_eigenvectors
    if dp is not None and hasattr(dp, "close"):
        dp.close()
    return list(res.history), report


if __name__ == "__main__":
    sys.exit(main())
