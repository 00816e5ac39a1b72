"""Lanczos eigensolver for the generalized problem K x = lambda M x, as in
maxwell_tpu/solvers/lanczos.py (config 1).

- The Krylov factorization is a Python loop of `maxiter` steps over
  preallocated basis buffers V and MV, which it updates in place row by
  row (the reference carries them through a jit-ed fori_loop). The operator
  apply, the M-inner products and the full two-pass reorthogonalization run
  on the pencil's device; nothing is read back to the host inside the loop
  except by the operator's own inner CG.
- The operator is abstract: `apply_op(x)` must be M-self-adjoint. In the
  direct mode it is P M^-1 K (P = gradient-nullspace projector).
- Only the small tridiagonal eigensolve runs on the host, in float64; the
  Ritz vectors V @ Y and the residuals go back to the device.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import scipy.linalg
import torch

from maxwell_tpu_torch.solvers.results import EigenResult
from maxwell_tpu_torch.utils.precision import fp32_true


def _direct_apply(pencil, x: torch.Tensor) -> torch.Tensor:
    """Operator for the direct generalized mode: P M^-1 K x."""
    return pencil.project(pencil.Minv_mm(pencil.K_mm(x)))


def _project_apply(pencil, x: torch.Tensor) -> torch.Tensor:
    return pencil.project(x)


def start_vector(pencil, v0=None, generator: torch.Generator | None = None):
    """The projected, zero-padded start vector on the pencil's device: v0
    (numpy or torch, length n or n_padded; rows past n are dropped) or
    standard normal draws from `generator` on its device (default: seed 0
    on the CPU, so every device starts from the same vector)."""
    n_pad, n = pencil.n_padded, pencil.n
    dtype, device = pencil.dtype, pencil.device
    if v0 is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        v0 = torch.randn(n_pad, generator=generator, dtype=dtype,
                         device=generator.device)
    elif not torch.is_tensor(v0):
        v0 = torch.from_numpy(np.array(v0, dtype=np.float64))
    v = torch.zeros(n_pad, dtype=dtype, device=device)
    v[:n] = v0.reshape(-1)[:n].to(dtype=dtype, device=device)
    return pencil.project(v)


def lanczos_factorization(
    apply_op: Callable,
    pencil,
    v0: torch.Tensor,
    maxiter: int,
    post: Callable | None = None,
):
    """Run `maxiter` Lanczos steps in the M-inner product.

    The pencil supplies M applies and the reductions. Returns (alphas (k,),
    betas (k,), V (k+1, n), MV (k+1, n)), all on the device. V rows are
    M-orthonormal; T = tridiag(betas[:-1], alphas) is the projected
    operator. Full two-pass reorthogonalization each step; post (the
    nullspace projection) is applied to each new vector after it.
    """
    M_mm = pencil.M_mm
    dot = pencil.dot_vv
    n = v0.shape[0]
    k = maxiter

    Mv0 = M_mm(v0)
    beta0 = torch.sqrt(dot(v0, Mv0))
    V = v0.new_zeros((k + 1, n))
    MV = v0.new_zeros((k + 1, n))
    V[0] = v0 / beta0
    MV[0] = Mv0 / beta0
    alphas = v0.new_zeros(k)
    betas = v0.new_zeros(k)

    for j in range(k):
        w = apply_op(V[j])
        alphas[j] = dot(w, MV[j])
        # two-pass full reorthogonalization against the basis so far; rows
        # of V and MV past j are still zero, so the full products need no
        # mask
        for _ in range(2):
            coeffs = pencil.dot_basis(MV, w)
            w = w - V.T @ coeffs
        if post is not None:
            # roundoff regenerates gradient components that the operator
            # then annihilates, polluting the small end of the spectrum
            w = post(w)
        Mw = M_mm(w)
        beta = torch.sqrt(torch.clamp(dot(w, Mw), min=0.0))
        betas[j] = beta
        safe = torch.where(beta > 0, beta, torch.ones_like(beta))
        V[j + 1] = w / safe
        MV[j + 1] = Mw / safe
    return alphas, betas, V, MV


def ritz_extract(
    alphas: np.ndarray,
    betas: np.ndarray,
    nev: int,
    tol: float,
    mode: str,
    sigma: float = 0.0,
):
    """Host-side Ritz selection from the tridiagonal T (a copy of
    maxwell_tpu/solvers/lanczos.py:ritz_extract).

    Returns (lams (nev,), Y_selected (keff, nev), keff). Keeps only
    converged pairs (classic bound |beta_k y_k,i|); in direct mode drops
    the residual lambda~0 nullspace junk that roundoff re-introduces.
    """
    a = np.asarray(alphas, dtype=np.float64)
    b = np.asarray(betas, dtype=np.float64)
    maxiter = len(a)

    # effective Krylov size: stop at first (near-)breakdown
    keff = maxiter
    tiny = 1e-12 * max(np.abs(a).max(), 1.0)
    for j in range(maxiter - 1):
        if b[j] <= tiny:
            keff = j + 1
            break
    theta, Y = scipy.linalg.eigh_tridiagonal(a[:keff], b[: keff - 1])

    beta_last = b[keff - 1] if keff >= 1 else 0.0
    est = np.abs(beta_last * Y[-1, :])
    theta_max = max(np.abs(theta).max(), 1.0)
    conv = est <= np.maximum(1e3 * tol * np.abs(theta), 1e-12 * theta_max)

    if mode == "direct":
        keep = conv & (theta > 1e-10 * theta_max)
        idx = np.where(keep)[0]
        order = idx[np.argsort(theta[idx])][:nev]
        lams = theta[order]
    elif mode == "shift_invert":
        keep = conv & (np.abs(theta) > 1e-12 * theta_max)
        idx = np.where(keep)[0]
        order = idx[np.argsort(-np.abs(theta[idx]))][:nev]
        lams = sigma + 1.0 / theta[order]
        asc = np.argsort(lams)
        order, lams = order[asc], lams[asc]
    else:
        raise ValueError(mode)
    if len(order) < nev:
        # not enough CONVERGED pairs: fall back to the best unconverged
        # candidates (flagged via residuals/converged) — but keep the
        # nullspace/junk filter and the mode's ranking, and re-sort the
        # final set ascending like the converged path does.
        pool = np.where(
            (theta > 1e-10 * theta_max)
            if mode == "direct"
            else (np.abs(theta) > 1e-12 * theta_max)
        )[0]
        ranked = pool[
            np.argsort(theta[pool] if mode == "direct" else -np.abs(theta[pool]))
        ]
        rest = ranked[~np.isin(ranked, order)][: nev - len(order)]
        order = np.concatenate([order, rest]).astype(int)
        lams = (
            theta[order] if mode == "direct" else sigma + 1.0 / theta[order]
        )
        asc = np.argsort(lams)
        order, lams = order[asc], lams[asc]
    return lams, Y[:, order], keff


def relative_residuals(pencil, X: torch.Tensor, lams) -> np.ndarray:
    """||K x - lam M x|| / (||K x|| + |lam| ||M x||) per column, on the
    device; returned on the host."""
    KX, MX = pencil.K_mm(X), pencil.M_mm(X)
    lam_d = torch.as_tensor(np.asarray(lams), dtype=X.dtype, device=X.device)
    R = KX - MX * lam_d[None, :]
    scale = pencil.col_norms(KX) + lam_d.abs() * pencil.col_norms(MX)
    return (pencil.col_norms(R) / torch.clamp(scale, min=1e-30)).cpu().numpy()


@fp32_true
def lanczos(
    pencil,
    nev: int = 5,
    maxiter: int = 100,
    tol: float = 1e-8,
    v0=None,
    generator: torch.Generator | None = None,
    mode: str = "direct",
    apply_op: Callable | None = None,
    sigma: float = 0.0,
    return_device: bool = False,
) -> EigenResult:
    """Solve K x = lambda M x for the `nev` smallest (direct mode) or the
    `nev` closest-to-sigma (shift-invert mode) eigenpairs.

    v0: start vector (numpy or torch, length n or n_padded); default
    standard normal draws from `generator` (see start_vector).
    mode="direct": operator P M^-1 K; eigenvalues are theta directly.
    mode="shift_invert": caller supplies apply_op = P (K-sigma M)^-1 M;
    eigenvalues are sigma + 1/theta, largest |theta| first.
    return_device: eigenvectors is the (n_padded, nev) Ritz block on the
    pencil's device (a sharded pencil's stacked rows).
    """
    v = start_vector(pencil, v0, generator)
    if apply_op is None:
        if mode != "direct":
            raise ValueError("supply apply_op for non-direct modes")
        apply_op = functools.partial(_direct_apply, pencil)
    post = (
        functools.partial(_project_apply, pencil)
        if pencil.proj is not None
        else None
    )
    alphas, betas, V, _ = lanczos_factorization(
        apply_op, pencil, v, maxiter, post
    )
    alphas, betas = alphas.cpu().numpy(), betas.cpu().numpy()
    lams, Y_sel, keff = ritz_extract(alphas, betas, nev, tol, mode, sigma)
    Yd = torch.as_tensor(Y_sel, dtype=V.dtype, device=V.device)
    X = V[:keff].T @ Yd  # (n_pad, nev) Ritz vectors
    res = relative_residuals(pencil, X, lams)
    return EigenResult(
        eigenvalues=np.asarray(lams),
        eigenvectors=X if return_device else X[: pencil.n].cpu().numpy(),
        residuals=res,
        iterations=keff,
        converged=bool(np.all(res <= tol)),
        tridiagonal=(alphas, betas),
    )
