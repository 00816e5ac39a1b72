"""On-device high-precision eigenpair refinement to 1e-8 for PEC stencil
pencils: the single-device part of maxwell_tpu/solvers/refine_device.py.

Method: Rayleigh-quotient iteration in DOUBLE-WORD f32 arithmetic
(utils/twofloat, ~2^-48 unit roundoff) with the spectral shift solve as the
inner solver (solvers/spectral.solve_sigma):

    per sweep, per column j (all over the block):
      theta_j = (x K x)/(x M x)          double-word Rayleigh quotient
      r_j     = K x - theta_j M x        double-word residual (the f32
                                         apply floors at ~1e-7 rel; the
                                         dw apply at ~1e-13)
      sigma_j = theta_j (1 - 3e-3)
      x_j    <- x_j - (K - sigma_j M)^-1 r_j     f32 solve, dw update

The update x - S(r) is the classical RQI direction written as a small
correction, so an f32-accurate solve suffices. Vacuum pencils solve the
correction exactly by the spectral shift solve; loaded PEC pencils by
preconditioned block MINRES with the vacuum (K + 15 M)^-1 as SPD
preconditioner. Degenerate clusters are re-separated by a final block
Rayleigh-Ritz: double-word Gram matrices, an f64 host eigh of the (m, m)
pencil, a double-word basis rotation on the device.

The reference fuses the sweeps into one compiled while_loop; here they are
a Python loop with one host read of the (m,) residual per sweep and the
same trip-count rule: stop one sweep after the pre-update residual first
reaches tol (that sweep's update is applied), at most min(max_sweeps, 5)
sweeps for vacuum pencils and min(max_sweeps, 8) for loaded ones.

Not ported yet: refine_dw_dist (slice 4).
"""

from __future__ import annotations

import numpy as np
import torch

from maxwell_tpu_torch.solvers.results import EigenResult
from maxwell_tpu_torch.utils import twofloat as tf


def _dw_div_cols(nh, nl, dh, dl):
    """Per-column dw division (m,)/(m,): Newton-refined quotient."""
    q1 = nh / dh
    ph, pl = tf.dw_mul(q1, torch.zeros_like(q1), dh, dl)
    rh, rl = tf.dw_add(nh, nl, -ph, -pl)
    q2 = (rh + rl) / dh
    return tf.fast_two_sum(q1, q2)


def _rq_and_residual(pencil, Xh, Xl):
    """theta (dw), scaled residual norms, and R (dw) for the block."""
    (KXh, KXl), (MXh, MXl) = pencil.KM_mm_dw(Xh, Xl)
    numh, numl = tf.dw_dot_cols(Xh, Xl, KXh, KXl)
    denh, denl = tf.dw_dot_cols(Xh, Xl, MXh, MXl)
    th, tl = _dw_div_cols(numh, numl, denh, denl)
    # R = KX - theta*MX
    tMh, tMl = tf.dw_mul(MXh, MXl, th[None, :], tl[None, :])
    Rh, Rl = tf.dw_add(KXh, KXl, -tMh, -tMl)
    # norms from the hi words (residuals >> 1e-30: hi carries them fully)
    nR = torch.linalg.norm(Rh, dim=0)
    nK = torch.linalg.norm(KXh, dim=0)
    nM = torch.linalg.norm(MXh, dim=0)
    res = nR / torch.clamp(nK + torch.abs(th) * nM, min=1e-30)
    return th, tl, res, Rh, Rl


def _sweep(pencil, sol, Xh, Xl, sigma_rel, inner_iters, exact):
    """One refinement sweep: the pre-update (theta, residual) and the
    updated dw block."""
    th, tl, res, Rh, Rl = _rq_and_residual(pencil, Xh, Xl)
    sigma = th * (1.0 - sigma_rel)
    mk = pencil.mask[:, None]
    if exact:
        # R's low words are ~1e-7 of R, below what the f32 solve resolves,
        # so the hi word alone is the right-hand side
        W = sol.solve_sigma(Rh, sigma) * mk
    else:
        from maxwell_tpu_torch.solvers.minres import pminres_block

        def A_mv(Z):
            return pencil.K_mm(Z) - pencil.M_mm(Z) * sigma[None, :]

        def P_mv(Z):
            return sol.solve(Z) * mk

        W = pminres_block(A_mv, P_mv, Rh, iters=inner_iters) * mk
    # no per-element renormalization: dividing each word by an f32 norm
    # injects ~1e-7 direction noise; the final Rayleigh-Ritz restores
    # M-orthonormality
    Xh, Xl = tf.dw_add(Xh, Xl, -W, torch.zeros_like(W))
    return Xh, Xl, th, tl, res


def _grams(pencil, Xh, Xl):
    (KXh, KXl), (MXh, MXl) = pencil.KM_mm_dw(Xh, Xl)
    Ah, Al = tf.dw_gram(Xh, Xl, KXh, KXl)
    Bh, Bl = tf.dw_gram(Xh, Xl, MXh, MXl)
    return Ah, Al, Bh, Bl


def _robust_geig(A, B):
    """Generalized eigh of the (m, m) RR pencil, robust to a rank-deficient
    B: columns of the refined block that collapsed onto a common
    eigenvector make B singular and plain scipy eigh raises. Fallback:
    SVQB-style whitening against B's well-conditioned eigenspace; collapsed
    directions are dropped and reported via n_dropped so the caller can
    mark those columns unconverged (their rotated columns are zero, and a
    zero vector must not read as residual 0)."""
    import scipy.linalg

    try:
        th, C = scipy.linalg.eigh(A, B)
        return th, C, 0
    except np.linalg.LinAlgError:
        lam, V = scipy.linalg.eigh(B)
        keep = lam > 1e-10 * max(lam.max(), 1e-300)
        T = V[:, keep] / np.sqrt(lam[keep])[None, :]
        th, C = scipy.linalg.eigh(T.T @ A @ T)
        Cf = T @ C
        m = A.shape[0]
        n_drop = m - Cf.shape[1]
        if n_drop:
            Cf = np.pad(Cf, ((0, 0), (0, n_drop)))
            th = np.concatenate([th, np.full(n_drop, np.nan)])
        return th, Cf, n_drop


def _rotate_final(pencil, Xh, Xl, Ch, Cl):
    """RR rotation and the fresh dw residual."""
    Xh, Xl = tf.dw_matmul_small(Xh, Xl, Ch, Cl)
    th, tl, res, _, _ = _rq_and_residual(pencil, Xh, Xl)
    return Xh, Xl, th, tl, res


def refine_dw_supports(pencil) -> bool:
    """Whether `refine_dw` takes this pencil: a PEC tap pencil, vacuum
    (dw taps) or loaded (dw field taps)."""
    return getattr(pencil, "taps_dw", None) is not None or (
        getattr(pencil, "ftaps_Kdw", None) is not None
        and getattr(pencil, "bc", "pec") == "pec"
    )


def refine_dw(
    pencil,
    X,
    tol: float = 1e-8,
    max_sweeps: int | None = None,
    sigma_rel: float = 3e-3,
    inner_iters: int = 32,
) -> EigenResult:
    """Refine approximate eigenvectors X of a PEC stencil pencil to `tol`
    relative residual on the pencil's device (see module doc).

    X: the f32 block of the f32 LOBPCG (residuals ~1e-3..1e-5), a host
    (n, m) array or an (n, m) / (n_padded, m) tensor. Vacuum pencils
    (taps_dw) use the exact per-column spectral shift solve per sweep;
    loaded PEC pencils (dw field taps) solve each sweep's correction by
    preconditioned block MINRES (`inner_iters` steps). Returns the
    eigenvectors reconstructed in f64 on the host, (n, m)."""
    from maxwell_tpu_torch.solvers.spectral import SpectralShiftSolver

    if not refine_dw_supports(pencil):
        raise ValueError(
            "refine_dw needs a PEC tap pencil (vacuum or loaded)"
        )
    exact = getattr(pencil, "taps_dw", None) is not None
    if max_sweeps is None:
        max_sweeps = 6 if exact else 12
    device = pencil.device
    sol = SpectralShiftSolver.build(
        pencil.a, pencil.b, pencil.c, pencil.nx, pencil.ny, pencil.nz,
        alpha=0.0 if exact else 15.0, n_padded=pencil.n_padded,
        dtype=torch.float32, device=device,
    )
    X = torch.as_tensor(X).to(device=device, dtype=torch.float32)
    if X.dim() == 1:
        X = X[:, None]
    Xh = X.new_zeros((pencil.n_padded, X.shape[1]))
    Xh[: X.shape[0]] = X
    Xl = torch.zeros_like(Xh)

    # stop one sweep after the pre-update residual first measures <= tol
    # (that sweep's update is still applied, so the final residual lands
    # well below tol)
    n_sweeps = min(max_sweeps, 5 if exact else 8)
    sweeps, res_max = 0, float("inf")
    while sweeps < n_sweeps and res_max > tol:
        Xh, Xl, th, tl, res = _sweep(
            pencil, sol, Xh, Xl, sigma_rel, inner_iters, exact
        )
        res_max = float(torch.max(res))  # the per-sweep host read
        sweeps += 1
    hist = [{
        "iter": sweeps - 1,
        "max_rel_res": res_max,
        "note": "pre-update residual of the LAST sweep",
    }]

    # final Rayleigh-Ritz: separate degenerate clusters, f64-exact on the
    # (m, m) pencil; rotation applied in dw on the device
    Ah, Al, Bh, Bl = _grams(pencil, Xh, Xl)
    A = tf.dw_to_f64(Ah, Al)
    B = tf.dw_to_f64(Bh, Bl)
    theta64, C, n_drop = _robust_geig(0.5 * (A + A.T), 0.5 * (B + B.T))
    Ch, Cl = (torch.from_numpy(v).to(device) for v in tf.dw_from_f64(C))
    Xh, Xl, th, tl, res = _rotate_final(pencil, Xh, Xl, Ch, Cl)
    theta = tf.dw_to_f64(th, tl)
    res = res.cpu().numpy().astype(np.float64)
    if n_drop:
        res[-n_drop:] = np.inf  # zeroed collapsed columns: unconverged
    hist.append({"iter": len(hist), "max_rel_res": float(res.max())})
    return EigenResult(
        eigenvalues=theta,
        eigenvectors=tf.dw_to_f64(Xh, Xl)[: pencil.n],
        residuals=res,
        iterations=sweeps + 1,
        converged=bool(res.max() <= tol),
        history=hist,
    )
