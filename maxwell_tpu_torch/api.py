"""Top-level API: solve a cavity eigenproblem in one call.

    import maxwell_tpu_torch
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem
    res = maxwell_tpu_torch.solve(
        PermutedProblem(BrickCavity3D(nx=24, ny=24, nz=24)), nev=5,
        dtype=torch.float32, device="cuda",
    )
"""

from __future__ import annotations

import time

import torch

from maxwell_tpu_torch.utils.precision import fp32_true


@fp32_true
def solve(
    problem,
    nev: int = 5,
    tol: float = 1e-8,
    solver: str = "lobpcg",
    sigma: float | None = None,
    maxiter: int | None = None,
    dtype: torch.dtype = torch.float64,
    block: int | None = None,
    kernel: str = "auto",
    distributed: bool = False,
    n_shards: int | None = None,
    refine: bool | str = "auto",
    device: str | torch.device = "cuda",
    **kwargs,
):
    """Solve K x = lambda M x for `problem` (RectCavity2D / BrickCavity3D /
    PermutedProblem) on `device`.

    solver: "lobpcg" (preconditioned; the shift is auto-tuned from the
    analytic oracle when there is one), "lanczos" (solvers/lanczos.py,
    maxiter default 300) or "shift_invert" (solvers/shift_invert.py: the
    nev modes nearest `sigma`, which it needs; maxiter default 60; K -
    sigma M factored on the host, no refine).

    kernel: "auto" — the BELLUnion CUDA kernels ("union") on a CUDA device
    at f32, the plain blocked-ELL apply ("ref") otherwise — or an explicit
    "ref" | "union" | "pallas" (blocked-ELL with 8x8 blocks through its
    CUDA SpMM/SpMV kernels) | "bellpairs" (paired-chunk blocked-ELL with
    K and M on one pair structure, through its fused K/M and one-stream
    CUDA SpMM kernels); the "pallas" and "bellpairs" kernels take f32
    only on a CUDA device. A "union", "pallas" or "bellpairs" pencil on a
    CPU device runs the kernels' plain PyTorch versions.

    distributed=True: LOBPCG on a row-sharded pencil (dist/partition.py)
    of n_shards row shards (default 1), all on `device`; kernel "ref",
    "union" or "pallas".

    refine: mixed-precision polish (solvers/refine.py). "auto" applies it
    when dtype is f32 and tol is below the f32 floor (1e-6): the device
    solves to 1e-5, then f64 Rayleigh-quotient-shifted inverse iteration on
    the host reaches tol.

    Further keyword arguments go to the solver: lobpcg (stall_window, X0,
    log_every, ...), lanczos (v0, generator) or shift_invert_lanczos (v0,
    generator, backend, KM); an f32 LOBPCG that a refine
    follows takes stall_window=15 unless one is given; precond_alpha sets
    LOBPCG's preconditioner shift (default: the smallest analytic
    eigenvalue when the problem has an oracle, else 1).
    """
    device = torch.device(device)
    if solver not in ("lobpcg", "lanczos", "shift_invert"):
        raise ValueError(f"unknown solver {solver!r}")
    if kernel == "auto":
        kernel = (
            "union"
            if device.type == "cuda" and dtype == torch.float32
            else "ref"
        )

    want_refine = refine is True or (
        refine == "auto" and dtype == torch.float32 and tol < 1e-6
    )
    device_tol = max(tol, 1e-5) if want_refine else tol
    # an f32 LOBPCG that a refine follows is cut at its floor and hands over
    # its best block (the CLI's rule, cli/run.py): bouncing on at the floor
    # can break the block down, and the refine then converges to other
    # eigenpairs (config 2 at f32). A caller's stall_window, 0 included, wins.
    if solver == "lobpcg" and want_refine and dtype == torch.float32:
        kwargs.setdefault("stall_window", 15)

    # auto preconditioner shift: the scale of the smallest wanted mode
    alpha = kwargs.pop("precond_alpha", None)
    if alpha is None:
        oracle = getattr(problem, "analytic_eigenvalues", None)
        alpha = float(oracle(1)[0]) if oracle is not None else 1.0

    if distributed:
        from maxwell_tpu_torch.dist import make_mesh, partition_problem
        from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist

        if solver != "lobpcg":
            raise ValueError("the distributed path is LOBPCG only")
        mesh = make_mesh(n_shards or 1, device)
        t0 = time.perf_counter()
        dp = partition_problem(problem, mesh.D, block=block, kernel=kernel,
                               dtype=dtype, mesh=mesh)
        setup_s = time.perf_counter() - t0
        res = lobpcg_dist(dp, mesh, nev=nev, maxiter=maxiter or 200,
                          tol=device_tol, precond_alpha=alpha, **kwargs)
        res.timings.update(setup_s=setup_s,
                           device_solve_s=time.perf_counter() - t0 - setup_s)
        return _maybe_refine(problem, res, tol, want_refine)

    from maxwell_tpu_torch.solvers.operator import Pencil

    t0 = time.perf_counter()
    pencil = Pencil.from_problem(
        problem, block=block, kernel=kernel, dtype=dtype, device=device
    )
    setup_s = time.perf_counter() - t0
    if solver == "shift_invert":
        if sigma is None:
            raise ValueError("shift_invert needs sigma")
        from maxwell_tpu_torch.solvers.shift_invert import (
            shift_invert_lanczos,
        )

        return shift_invert_lanczos(
            pencil, sigma=sigma, nev=nev, maxiter=maxiter or 60, tol=tol,
            **kwargs,
        )
    # both solvers return host arrays, so the clock stops after the device
    # work
    if solver == "lanczos":
        from maxwell_tpu_torch.solvers.lanczos import lanczos

        t0 = time.perf_counter()
        res = lanczos(
            pencil, nev=nev, maxiter=maxiter or 300, tol=device_tol, **kwargs
        )
    else:
        from maxwell_tpu_torch.solvers.lobpcg import lobpcg
        from maxwell_tpu_torch.solvers.precond import (
            shifted_cg_preconditioner,
        )

        pc = shifted_cg_preconditioner(pencil, alpha=alpha, iters=20)
        t0 = time.perf_counter()
        res = lobpcg(
            pencil, nev=nev, maxiter=maxiter or 200, tol=device_tol,
            precond=pc, **kwargs,
        )
    res.timings.update(
        setup_s=setup_s, device_solve_s=time.perf_counter() - t0
    )
    return _maybe_refine(problem, res, tol, want_refine)


def _maybe_refine(problem, res, tol, want_refine):
    if not want_refine or res.eigenvectors is None:
        return res
    from maxwell_tpu_torch.solvers.refine import refine_f64
    from maxwell_tpu_torch.solvers.results import EigenResult

    t0 = time.perf_counter()
    ref = refine_f64(
        problem, res.eigenvectors, theta=res.eigenvalues, tol=tol
    )
    return EigenResult(
        eigenvalues=ref.eigenvalues,
        eigenvectors=ref.eigenvectors,
        residuals=ref.residuals,
        iterations=res.iterations + ref.iterations,
        converged=ref.converged,
        history=list(res.history) + ref.history,
        timings={**res.timings, "refine_s": time.perf_counter() - t0},
    )
