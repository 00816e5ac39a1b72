"""Rayleigh-Ritz and block M-orthonormalization.

The small dense eigenproblems run on the tensors' device (`small_eigh`: in
float64 whatever the working dtype) and the tall-skinny orthonormalization
is SVQB/CholQR — Gram-matrix based, so the n-dimensional work is
tall-skinny matrix products.
"""

from __future__ import annotations

import torch


def _local_dot(A, B):
    return A.T @ B


def small_eigh(A: torch.Tensor):
    """Eigen-decomposition (theta ascending, V) of a small symmetric matrix
    (at most 3m x 3m in LOBPCG), computed in float64 on A's own device and
    returned in A's dtype. A is symmetrised first.

    The JAX package runs this eigh in the working dtype
    (maxwell_tpu/solvers/rr.py:30, :59, lobpcg.py:201). In float32 on an
    H100, torch.linalg.eigh (cuSOLVER) leaves 2.6-3.5x LAPACK's
    eigen-residual, and that alone held the card's f32 LOBPCG 2-3x above
    the CPU's floor (PERF.md section 7, bench/f32_floor.py). The matrices
    are tiny, so one float64 path serves every device."""
    A64 = A.to(torch.float64)
    theta, V = torch.linalg.eigh(0.5 * (A64 + A64.T))
    return theta.to(A.dtype), V.to(A.dtype)


def eigh_gen(A: torch.Tensor, B: torch.Tensor, eps: float = 1e-12):
    """Small dense generalized symmetric eigensolve A c = theta B c (B SPD
    up to roundoff) by Cholesky reduction. Returns (theta ascending, C)
    with C^T B C = I."""
    m = A.shape[0]
    I = torch.eye(m, dtype=B.dtype, device=B.device)
    B = B + eps * torch.trace(B) / m * I
    L = torch.linalg.cholesky(B)
    Ainv = torch.linalg.solve_triangular(L, A, upper=False)  # L^-1 A
    At = torch.linalg.solve_triangular(L, Ainv.T, upper=False)
    At = 0.5 * (At + At.T)
    theta, V = small_eigh(At)
    C = torch.linalg.solve_triangular(L.T, V, upper=True)  # L^-T V
    return theta, C


def svqb(S: torch.Tensor, MS: torch.Tensor, dot_mm=None,
         eps: float | None = None, cond: bool = False):
    """SVQB M-orthonormalization of a block S (n x m), given MS = M @ S.

    Returns (S_orth, MS_orth, rank_mask, T) with S_orth = S @ T. Columns
    whose scaled Gram eigenvalue falls below eps * max are zeroed
    (rank_mask False there). cond: also return the condition number of
    the kept scaled Gram matrix (its largest eigenvalue over its smallest
    kept one), a host float: S_orth's loss of M-orthonormality grows with
    it.
    """
    if dot_mm is None:
        dot_mm = _local_dot
    fi = torch.finfo(S.dtype)
    if eps is None:
        # rank cutoff just above the Gram-matrix noise floor of the dtype
        eps = 100.0 * fi.eps
    G = dot_mm(S, MS)
    G = 0.5 * (G + G.T)
    # mask dead columns at the scaling step with a RELATIVE cutoff
    dg = torch.diagonal(G)
    ok = dg > torch.max(dg) * fi.eps**2
    Dinv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, dg, 1.0)), 0.0)
    Gs = G * Dinv[:, None] * Dinv[None, :]
    theta, V = small_eigh(Gs)
    good = theta > eps * torch.max(theta)
    inv_sqrt = torch.where(
        good, 1.0 / torch.sqrt(torch.abs(theta)), 0.0
    )
    T = (Dinv[:, None] * V) * inv_sqrt[None, :]
    if cond:
        top = torch.max(theta)
        kept = torch.min(torch.where(good, theta, top))
        return S @ T, MS @ T, good, T, float(top / kept)
    return S @ T, MS @ T, good, T


def cholqr(S: torch.Tensor, MS: torch.Tensor, dot_mm=None,
           eps: float = 1e-12):
    """Cholesky-QR M-orthonormalization: S <- S R^-1 with S^T M S = R^T R.
    Returns (S_orth, MS_orth)."""
    if dot_mm is None:
        dot_mm = _local_dot
    G = dot_mm(S, MS)
    G = 0.5 * (G + G.T)
    m = G.shape[0]
    G = G + eps * torch.trace(G) / m * torch.eye(
        m, dtype=G.dtype, device=G.device
    )
    R = torch.linalg.cholesky(G).T  # upper
    Si = torch.linalg.solve_triangular(R, S, upper=True, left=False)
    MSi = torch.linalg.solve_triangular(R, MS, upper=True, left=False)
    return Si, MSi


def rayleigh_ritz(
    S: torch.Tensor, KS: torch.Tensor, MS: torch.Tensor, nev: int,
    dot_mm=None,
):
    """Project K, M onto span(S) and solve the small generalized problem.
    Returns (theta[:nev], C[:, :nev]), Ritz values ascending."""
    if dot_mm is None:
        dot_mm = _local_dot
    A = dot_mm(S, KS)
    B = dot_mm(S, MS)
    A = 0.5 * (A + A.T)
    B = 0.5 * (B + B.T)
    theta, C = eigh_gen(A, B)
    return theta[:nev], C[:, :nev]
