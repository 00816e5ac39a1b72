"""Thick-restart Lanczos (Wu-Simon / Krylov-Schur class), the
memory-bounded Krylov eigensolver of maxwell_tpu/solvers/trlanczos.py, on
one device.

Plain Lanczos needs a basis as large as the Krylov space; thick restart caps
it at `ncv` columns: after each cycle the basis collapses to the `nkeep`
best Ritz vectors plus the last Lanczos vector, the projected matrix becomes
an arrowhead, and expansion continues. Memory is O(n*ncv) regardless of
total iterations.

- Works in the M-inner product on the abstract pencil operator (direct mode
  P M^-1 K, or any M-self-adjoint apply such as shift-invert).
- Full two-pass reorthogonalization; the projected matrix H is kept DENSE
  (ncv x ncv) on the host, robust to the arrowhead structure and roundoff.
- Each expansion step runs on the device and writes its basis row in place
  in the preallocated V/MV buffers; the small eigh runs on the host between
  cycles.
- `thick_restart_lanczos_dist` runs the same cycles on a row-sharded
  DistPencil (dist/partition.py) or a slab-sharded DistStencilPencil3D,
  whose stacked view supplies the per-shard reductions and halo exchanges,
  in direct or shift-invert mode.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from maxwell_tpu_torch.solvers.lanczos import (
    _direct_apply,
    _project_apply,
    relative_residuals,
    start_vector,
)
from maxwell_tpu_torch.solvers.results import EigenResult
from maxwell_tpu_torch.utils.precision import fp32_true


def _expand_step(apply_op, pencil, V, MV, j, post=None):
    """One Krylov expansion step from basis row j-1: writes row j of V and
    MV in place. Returns (h projection coefficients (ncv+1,), beta), both
    still on the device."""
    w = apply_op(V[j - 1])
    # projection coefficients BEFORE orthogonalization: h = (MV) w
    h = pencil.dot_basis(MV, w)  # rows >= j are zero
    for _ in range(2):
        c = pencil.dot_basis(MV, w)
        w = w - V.T @ c
    if post is not None:
        # nullspace hygiene: roundoff resurrects gradient components
        w = post(w)
    Mw = pencil.M_mm(w)
    beta = torch.sqrt(torch.clamp(pencil.dot_vv(w, Mw), min=0.0))
    safe = torch.where(beta > 0, beta, torch.ones_like(beta))
    V[j] = w / safe
    MV[j] = Mw / safe
    return h, beta


@fp32_true
def thick_restart_lanczos(
    pencil,
    nev: int = 5,
    ncv: int | None = None,
    max_restarts: int = 40,
    tol: float = 1e-8,
    v0=None,
    generator: torch.Generator | None = None,
    apply_op: Callable | None = None,
    mode: str = "direct",
    sigma: float = 0.0,
    return_device: bool = False,
) -> EigenResult:
    """Smallest (direct) or nearest-sigma (shift_invert apply_op) eigenpairs
    with an O(n*ncv) memory cap. ncv default: max(2*nev+10, 20). v0,
    generator and return_device as in lanczos()."""
    if ncv is None:
        ncv = max(2 * nev + 10, 20)
    if apply_op is None:
        if mode != "direct":
            raise ValueError("supply apply_op for non-direct modes")
        apply_op = functools.partial(_direct_apply, pencil)
    post = functools.partial(_project_apply, pencil)

    v = start_vector(pencil, v0, generator)
    Mv = pencil.M_mm(v)
    nrm = torch.sqrt(pencil.dot_vv(v, Mv))
    V = v.new_zeros((ncv + 1, v.shape[0]))
    MV = v.new_zeros((ncv + 1, v.shape[0]))
    V[0] = v / nrm
    MV[0] = Mv / nrm

    H = np.zeros((ncv + 1, ncv + 1))
    j = 1  # number of valid basis rows
    total_iters = 0
    converged = False
    theta = np.zeros(nev)

    for cycle in range(max_restarts):
        # --- expand to ncv rows ----------------------------------------
        while j <= ncv:
            h, beta = _expand_step(apply_op, pencil, V, MV, j, post)
            hj = h[:j].cpu().numpy()
            H[:j, j - 1] = hj
            H[j - 1, :j] = hj  # M-self-adjoint operator => symmetric H
            b = float(beta)
            H[j, j - 1] = b
            H[j - 1, j] = b
            total_iters += 1
            j += 1

        # --- Rayleigh-Ritz on the dense projected matrix ----------------
        Hs = 0.5 * (H[:ncv, :ncv] + H[:ncv, :ncv].T)
        w_, S = np.linalg.eigh(Hs)
        if mode == "direct":
            # nullspace junk (lambda ~ 0, resurrected by roundoff) sorts to
            # the END so selection/restart keeps only physical modes
            theta_max = max(np.abs(w_).max(), 1.0)
            bad = w_ <= 1e-8 * theta_max
            sel = np.argsort(w_ + bad * 1e3 * theta_max)
        else:
            sel = np.argsort(-np.abs(w_))
        w_, S = w_[sel], S[:, sel]

        beta_last = H[ncv, ncv - 1]
        resid_est = np.abs(beta_last * S[ncv - 1, :])
        scale = np.maximum(np.abs(w_), 1e-30)
        conv_mask = resid_est <= tol * scale
        if mode == "direct":
            # never declare convergence on nullspace junk that slipped into
            # the first nev slots
            theta_max2 = max(np.abs(w_).max(), 1.0)
            n_good = int((w_ > 1e-8 * theta_max2).sum())
            if n_good >= nev and conv_mask[:nev].all():
                converged = True
        elif conv_mask[:nev].all():
            converged = True
        theta = w_[:nev]

        nkeep = min(nev + max(5, nev // 2), ncv - 2)
        if converged or cycle == max_restarts - 1:
            nkeep = max(nkeep, nev)
            Sk = torch.as_tensor(S[:, :nkeep], dtype=V.dtype, device=V.device)
            X = V[:ncv].T @ Sk
            break

        # --- thick restart: collapse to nkeep Ritz vectors + last v -----
        Sk = torch.as_tensor(S[:, :nkeep], dtype=V.dtype, device=V.device)
        Vk = (V[:ncv].T @ Sk).T  # (nkeep, n)
        MVk = (MV[:ncv].T @ Sk).T
        V[:nkeep] = Vk
        MV[:nkeep] = MVk
        V[nkeep] = V[ncv]
        MV[nkeep] = MV[ncv]
        V[nkeep + 1:] = 0
        MV[nkeep + 1:] = 0
        H = np.zeros((ncv + 1, ncv + 1))
        H[:nkeep, :nkeep] = np.diag(w_[:nkeep])
        coup = beta_last * S[ncv - 1, :nkeep]
        H[nkeep, :nkeep] = coup
        H[:nkeep, nkeep] = coup
        j = nkeep + 1

    # --- extract ---------------------------------------------------------
    lams = theta if mode == "direct" else sigma + 1.0 / theta
    if mode == "shift_invert":
        order = np.argsort(lams[:nev])
        lams = lams[order]
        X = X[:, torch.as_tensor(order, device=X.device)]
    Xn = X[:, :nev].contiguous()
    res = relative_residuals(pencil, Xn, lams[:nev])
    return EigenResult(
        eigenvalues=np.asarray(lams[:nev]),
        eigenvectors=Xn if return_device else Xn[: pencil.n].cpu().numpy(),
        residuals=res,
        iterations=total_iters,
        converged=bool(np.all(res <= 10 * tol)),
    )


@fp32_true
def thick_restart_lanczos_dist(
    dpencil,
    mesh=None,
    nev: int = 5,
    ncv: int | None = None,
    max_restarts: int = 40,
    tol: float = 1e-8,
    v0=None,
    generator: torch.Generator | None = None,
    mode: str = "direct",
    sigma: float = 0.0,
    inner_tol: float = 1e-11,
    inner_iters: int = 400,
) -> EigenResult:
    """Distributed thick-restart Lanczos on a DistPencil or
    DistStencilPencil3D: the basis is (ncv + 1) stacked vectors, O(n ncv)
    as on one device. mode="shift_invert" takes the matrix-free MINRES
    apply (the operator of shift_invert_lanczos_dist). v0: start vector in
    the stacked layout, whole or this process's rows (dist_solve.
    start_rows; default: make_block(1) from `generator`). Across processes
    each rank holds the basis's rows of its shards (the expansion's V^T c
    is row-wise; dot_basis is reduced over the ranks). Eigenvectors come
    back in the problem's ordering."""
    from maxwell_tpu_torch.solvers.dist_solve import _check_mesh, start_rows

    if mode not in ("direct", "shift_invert"):
        raise ValueError(f"unknown mode {mode!r}")
    _check_mesh(dpencil, mesh)
    apply_op = None
    if mode == "shift_invert":
        from maxwell_tpu_torch.solvers.shift_invert import iterative_apply

        apply_op = iterative_apply(dpencil, sigma, inner_tol, inner_iters)
    res = thick_restart_lanczos(dpencil, nev=nev, ncv=ncv,
                                max_restarts=max_restarts, tol=tol,
                                v0=start_rows(dpencil, v0, generator),
                                apply_op=apply_op, mode=mode, sigma=sigma,
                                return_device=True)
    res.eigenvectors = dpencil.extract_vectors(res.eigenvectors)
    return res
