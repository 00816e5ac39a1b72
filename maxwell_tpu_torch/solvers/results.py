"""Solver result containers and residual reporting (SURVEY.md §5.5)."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class EigenResult:
    """Result of a (generalized) eigensolve K x = lambda M x.

    eigenvalues: (nev,) ascending.
    eigenvectors: (n, nev) — M-orthonormal columns, a host array; with a
    solver's return_device=True the device tensor in the pencil's padded
    or stacked layout, or the double-word pair (Xh, Xl) of two of them.
    residuals: (nev,) final relative residuals ||K x - lambda M x|| / scale.
    iterations: outer iterations taken.
    history: optional per-iteration metrics (list of dicts, JSON-able).
    timings: wall-clock seconds of the phases that produced it (solve()
    records "setup_s", "device_solve_s" and, when it refines, "refine_s").
    tridiagonal: lanczos()'s (alphas, betas) host arrays, the projected
    operator T = tridiag(betas[:-1], alphas); None from other solvers.
    """

    eigenvalues: np.ndarray
    eigenvectors: Any
    residuals: np.ndarray
    iterations: int
    converged: bool
    history: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    timings: dict[str, float] = dataclasses.field(default_factory=dict)
    tridiagonal: tuple | None = None

    def __repr__(self):
        ev = np.array2string(self.eigenvalues, precision=6, max_line_width=100)
        return (
            f"EigenResult(nev={len(self.eigenvalues)}, iters={self.iterations}, "
            f"converged={self.converged}, max_res={self.residuals.max():.2e},\n"
            f"  eigenvalues={ev})"
        )


def merge_stages(vals, vecs, resids, iters, hist, tol) -> EigenResult:
    """One result from the stages of a staged (`batch`) solve: the stages'
    pairs in ascending order."""
    lam = np.concatenate(vals)
    order = np.argsort(lam)
    res = np.concatenate(resids)
    return EigenResult(
        eigenvalues=lam[order],
        eigenvectors=np.concatenate(vecs, axis=1)[:, order],
        residuals=res[order],
        iterations=iters,
        converged=bool(res.max() <= tol),
        history=hist,
    )
