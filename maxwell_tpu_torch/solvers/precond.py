"""Preconditioner for the LOBPCG correction equation.

`shifted_cg_preconditioner`: W ~ (K + alpha M)^-1 R by a FIXED number of CG
sweeps. K + alpha M is SPD for alpha > 0 (alpha M fills K's gradient
nullspace), and the fixed sweep count keeps the preconditioner close to a
fixed linear operator, which LOBPCG tolerates well. Each sweep is one fused
K/M apply of the pencil.
"""

from __future__ import annotations

import functools

import torch

from maxwell_tpu_torch.solvers.cg import cg
from maxwell_tpu_torch.solvers.operator import Pencil


def _shifted_apply(pencil: Pencil, alpha: float, Z: torch.Tensor):
    KZ, MZ = pencil.KM_mm(Z)
    return KZ + alpha * MZ


def _precond_apply(pencil: Pencil, alpha: float, iters: int, R: torch.Tensor):
    # tol=0: no early exit above the dtype floor, so the operator is the
    # same polynomial in (K + alpha M) at every outer iteration
    return cg(
        functools.partial(_shifted_apply, pencil, alpha), R, tol=0.0,
        maxiter=iters, dot=pencil.dot_cols,
    )


def shifted_cg_preconditioner(
    pencil: Pencil, alpha: float = 1.0, iters: int = 20
):
    """Return a callable R -> W for lobpcg(..., precond=...).

    alpha: spectral shift, ~ the smallest wanted eigenvalue.
    iters: fixed CG sweep count per application.
    """
    return functools.partial(_precond_apply, pencil, alpha, iters)
