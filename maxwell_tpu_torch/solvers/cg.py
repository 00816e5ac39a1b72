"""Conjugate-gradient inner solves (multiple right-hand sides).

Used for the mass solve M^-1 X, the CG variant of the gradient projector
and the fixed-sweep shifted preconditioner. Same iteration as
maxwell_tpu/solvers/cg.py: columns that reach the floor (or whose direction
collapses) are frozen, so once every column is frozen further sweeps leave
X unchanged. The loop therefore tests for the early exit only every
_CHECK_EVERY sweeps — each test is a device-to-host sync — and returns the
same X as a test after every sweep.
"""

from __future__ import annotations

from typing import Callable

import torch

# sweeps between early-exit tests (each test is one device-to-host sync)
_CHECK_EVERY = 8


def cg(
    A_mm: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    x0: torch.Tensor | None = None,
    tol: float = 1e-10,
    maxiter: int = 200,
    dot=None,
) -> torch.Tensor:
    """Solve A X = B (SPD A) for X of shape (n, m) (or (n,)).

    A_mm: closure computing A @ X. dot: column-wise inner product
    (x, y) -> (m,). Stops when every column residual norm^2 <=
    tol_eff^2 * ||B||^2 (tol_eff = max(tol, 16 eps)), or after maxiter.
    """
    if dot is None:
        dot = lambda x, y: torch.sum(x * y, dim=0)

    vec_in = B.dim() == 1
    if vec_in:
        B = B[:, None]
    if x0 is None:
        X = torch.zeros_like(B)
    else:
        X = x0[:, None] if vec_in else x0

    # dtype-aware floor: iterating past the dtype's attainable residual
    # makes f32 CG explode (noise directions, vanishing denominators)
    fi = torch.finfo(B.dtype)
    tol_eff = max(tol, 16.0 * fi.eps)
    tiny = fi.tiny * 1e4

    # a zero start needs no apply: R = B exactly (saves one operator apply
    # per solve — one fused K/M kernel per preconditioner application)
    R = B if x0 is None else B - A_mm(X)
    P = R
    rs = dot(R, R)
    thr = (tol_eff * tol_eff) * torch.clamp(dot(B, B), min=fi.tiny)

    for it in range(maxiter):
        if it % _CHECK_EVERY == 0 and not bool(torch.any(rs > thr)):
            break
        AP = A_mm(P)
        denom = dot(P, AP)
        # per-column breakdown guard: freeze columns whose search direction
        # has collapsed (denom <= tiny) or that already hit the floor
        live = (denom > tiny) & (rs > thr)
        alpha = torch.where(live, rs / torch.where(live, denom, 1.0), 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        rs_new = dot(R, R)
        beta = torch.where(live, rs_new / torch.where(rs > 0, rs, 1.0), 0.0)
        P = R + beta[None, :] * P
        rs = torch.where(live, rs_new, rs * 0.0)
    return X[:, 0] if vec_in else X
