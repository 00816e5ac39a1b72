"""Mixed-precision residual refinement on the host in f64: a copy of
maxwell_tpu/solvers/refine.py::refine_f64 (scipy, assembled operators) and the
port of its matrix-free `refine_f64_pencil` (warm-started f64 LOBPCG on the
CPU).

Original notes (SURVEY.md §6 "time-to-1e-8"):

The BASELINE contract asks for eigenpair residuals at 1e-8 — below the
fp32 floor (~1e-5..1e-6 relative, problem-dependent) and far below what
f64-on-TPU emulation can reach in reasonable time (measured: >130 s per
LOBPCG iteration on the chip vs ~0.5 s in f32). The production design is
therefore mixed precision: the TPU does the heavy Krylov work in f32,
then a couple of f64 shift-invert sweeps on the host polish the block.

Each sweep is Rayleigh-quotient-shifted inverse iteration per column
(shift sigma_i = theta_i(1 - 1e-4): the small offset keeps K - sigma M
safely nonsingular while the contraction factor per step is
~1e-4*theta/gap — one sweep typically gains 3+ digits), followed by a
block M-orthonormalization (SVQB) + Rayleigh-Ritz that re-separates
degenerate clusters. Columns sharing a shift (degenerate pairs) share
one factorization. This is the same shift-invert machinery as SURVEY.md
§3.4 (C10), run in f64 on the converged block instead of from scratch.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from maxwell_tpu_torch.solvers.results import EigenResult


def _project_gradients(G, L_solve, M, X):
    """X <- X - G (G^T M G)^{-1} G^T M X in f64 (nullspace hygiene)."""
    if G is None:
        return X
    return X - G @ L_solve(G.T @ (M @ X))


def refine_f64(
    problem,
    X: np.ndarray,
    theta: np.ndarray | None = None,
    tol: float = 1e-8,
    max_steps: int = 6,
) -> EigenResult:
    """Polish approximate eigenvectors X (n, m) of K x = lambda M x to
    `tol` relative residual in f64 on the host.

    problem must expose scipy matrices K, M (and optionally the discrete
    gradient G whose range is K's nullspace). theta is unused beyond
    shaping (Ritz values are recomputed in f64) and kept for API clarity.
    """
    K = sp.csc_matrix(problem.K, dtype=np.float64)
    M = sp.csc_matrix(problem.M, dtype=np.float64)
    G = getattr(problem, "G", None)
    if G is not None:
        G = sp.csc_matrix(G, dtype=np.float64)
        L = (G.T @ (M @ G)).tocsc()
        L_solve = spla.factorized(L)
    else:
        L_solve = None

    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    m = X.shape[1]

    def residuals(X, theta):
        KX, MX = K @ X, M @ X
        R = KX - MX * theta[None, :]
        nR = np.linalg.norm(R, axis=0)
        scale = np.linalg.norm(KX, axis=0) + np.abs(theta) * np.linalg.norm(
            MX, axis=0
        )
        return nR / np.maximum(scale, 1e-300)

    hist = []
    theta = np.zeros((m,))
    res = np.full((m,), np.inf)
    for step in range(max_steps):
        X = _project_gradients(G, L_solve, M, X)
        # M-orthonormalize (SVQB): robust to the near-dependence the
        # inverse iteration induces between degenerate partners
        B = X.T @ (M @ X)
        w, V = np.linalg.eigh(0.5 * (B + B.T))
        good = w > w.max() * 1e-14
        T = V[:, good] / np.sqrt(w[good])
        X = X @ T
        # Rayleigh-Ritz on the orthonormal block — exact separation of
        # degenerate clusters, f64-accurate Ritz values for the shifts
        A = X.T @ (K @ X)
        theta, C = np.linalg.eigh(0.5 * (A + A.T))
        X = X @ C
        res = residuals(X, theta)
        hist.append({"iter": step, "max_rel_res": float(res.max())})
        if res.max() <= tol or step == max_steps - 1:
            break

        # Rayleigh-quotient-shifted inverse iteration sweep on the
        # unconverged columns; degenerate clusters share a factorization
        todo = np.flatnonzero(res > tol)
        MX = M @ X
        k = 0
        while k < len(todo):
            i = todo[k]
            cluster = [i]
            while (
                k + len(cluster) < len(todo)
                and abs(theta[todo[k + len(cluster)]] - theta[i])
                <= 1e-8 * max(abs(theta[i]), 1.0)
            ):
                cluster.append(todo[k + len(cluster)])
            sigma = theta[i] * (1.0 - 1e-4) if theta[i] != 0.0 else -1e-4
            lu = spla.splu((K - sigma * M).tocsc())
            X[:, cluster] = lu.solve(MX[:, cluster])
            k += len(cluster)

    return EigenResult(
        eigenvalues=theta[:m],
        eigenvectors=X,
        residuals=res,
        iterations=len(hist),
        converged=bool(res.max() <= tol),
        history=hist,
    )


def refine_f64_pencil(
    build_pencil,
    X: np.ndarray,
    tol: float = 1e-8,
    maxiter: int = 60,
    precond_alpha: float | None = 15.0,
    precond_iters: int = 16,
) -> EigenResult:
    """Matrix-free f64 polish: warm-started LOBPCG on the host CPU.

    The factorization-based `refine_f64` needs assembled scipy K/M; this
    variant never assembles anything. `build_pencil(dtype, device)` must
    return the SAME pencil (a layout matching X's rows); it is called with
    torch.float64 and device "cpu", and LOBPCG continues there from the
    f32 eigenvector block. Serves stencil pencils that `refine_dw` does not
    take (2D, PMC).
    """
    import torch

    from maxwell_tpu_torch.solvers.lobpcg import lobpcg
    from maxwell_tpu_torch.solvers.precond import shifted_cg_preconditioner

    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    nev = X.shape[1]
    pencil = build_pencil(torch.float64, "cpu")
    X0 = np.zeros((pencil.n_padded, nev))
    X0[: pencil.n] = X[: pencil.n]
    pc = None
    if precond_alpha is not None:
        try:
            # exact spectral solve when the pencil supports it (vacuum-PEC
            # taps)
            from maxwell_tpu_torch.solvers.spectral import (
                spectral_preconditioner,
            )

            pc = spectral_preconditioner(pencil, alpha=precond_alpha)
        except (ValueError, AttributeError):
            pc = shifted_cg_preconditioner(
                pencil, alpha=precond_alpha, iters=precond_iters
            )
    return lobpcg(
        pencil, nev=nev, m=nev, maxiter=maxiter, tol=tol, precond=pc, X0=X0,
    )
