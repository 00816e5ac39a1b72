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

refine_dw_dist is the same refinement on the slab-sharded vacuum stencil
pencil (dist/stencil_dist.py) in its stacked view: double-word slab tap
applies, the distributed spectral shift solve, and cross-slab double-word
sums taken in a fixed slab order (`_dw_allsum_pairs`: a plain sum would
round each word on its own and lose the pair's accuracy). It works in f32
pairs whatever the pencil's dtype. Across processes every rank calls it
(a collective): each rank's per-slab pairs, both words, are gathered from
every rank before the slab-order sum, so every rank takes the same host
decisions on the same bits.
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
    """One refinement sweep: the updated dw block and the pre-update
    residual."""
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
    return Xh, Xl, res


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


def _sweep_loop(step, Xh, Xl, n_sweeps, tol):
    """Run step(Xh, Xl) -> (Xh, Xl, res) and stop one sweep after the
    pre-update residual first measures <= tol (that sweep's update is still
    applied, so the final residual lands well below tol), at most n_sweeps;
    one host read of the (m,) residual per sweep. Returns (Xh, Xl, sweeps,
    hist)."""
    sweeps, res_max = 0, float("inf")
    while sweeps < n_sweeps and res_max > tol:
        Xh, Xl, res = step(Xh, Xl)
        res_max = float(torch.max(res))  # the per-sweep host read
        sweeps += 1
    hist = [{
        "iter": sweeps - 1,
        "max_rel_res": res_max,
        "note": "pre-update residual of the LAST sweep",
    }]
    return Xh, Xl, sweeps, hist


def _final_rr(pencil, Xh, Xl, grams, rq):
    """Final Rayleigh-Ritz: separate degenerate clusters, f64-exact on the
    (m, m) pencil of the dw Grams `grams(pencil, Xh, Xl)`; the rotation is
    applied in dw on the device and `rq(pencil, Xh, Xl)` gives the fresh
    theta and residual. Returns (Xh, Xl, theta f64, res f64 host)."""
    Ah, Al, Bh, Bl = grams(pencil, Xh, Xl)
    A = tf.dw_to_f64(Ah, Al)
    B = tf.dw_to_f64(Bh, Bl)
    _, C, n_drop = _robust_geig(0.5 * (A + A.T), 0.5 * (B + B.T))
    Ch, Cl = (torch.from_numpy(v).to(Xh.device) for v in tf.dw_from_f64(C))
    Xh, Xl = tf.dw_matmul_small(Xh, Xl, Ch, Cl)
    th, tl, res, _, _ = rq(pencil, Xh, Xl)
    res = res.cpu().numpy().astype(np.float64)
    if n_drop:
        res[-n_drop:] = np.inf  # zeroed collapsed columns: unconverged
    return Xh, Xl, tf.dw_to_f64(th, tl), res


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
    return_device: bool = False,
) -> EigenResult:
    """Refine approximate eigenvectors X of a PEC stencil pencil to `tol`
    relative residual on the pencil's device (see module doc).

    X: the f32 block of the f32 LOBPCG (residuals ~1e-3..1e-5), a host
    (n, m) array or an (n, m) tensor, or the padded (n_padded, m) device
    tensor of lobpcg(..., return_device=True), which is used as it is (no
    copy, never through the host). Vacuum pencils (taps_dw) use the exact
    per-column spectral shift solve per sweep; loaded PEC pencils (dw field
    taps) solve each sweep's correction by preconditioned block MINRES
    (`inner_iters` steps). Returns the eigenvectors reconstructed in f64 on
    the host, (n, m); with return_device=True the on-device double-word
    pair (Xh, Xl), each (n_padded, m) f32, and only the (m,) eigenvalues
    and residuals come to the host."""
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
    if torch.is_tensor(X) and X.dim() == 2 and (
        X.shape[0] == pencil.n_padded
    ):
        Xh = X.to(device=device, dtype=torch.float32)  # padded: as it is
    else:
        X = torch.as_tensor(X).to(device=device, dtype=torch.float32)
        if X.dim() == 1:
            X = X[:, None]
        Xh = X.new_zeros((pencil.n_padded, X.shape[1]))
        Xh[: X.shape[0]] = X
    Xl = torch.zeros_like(Xh)

    def step(Xh, Xl):
        return _sweep(pencil, sol, Xh, Xl, sigma_rel, inner_iters, exact)

    Xh, Xl, sweeps, hist = _sweep_loop(
        step, Xh, Xl, min(max_sweeps, 5 if exact else 8), tol)
    Xh, Xl, theta, res = _final_rr(pencil, Xh, Xl, _grams, _rq_and_residual)
    hist.append({"iter": len(hist), "max_rel_res": float(res.max())})
    return EigenResult(
        eigenvalues=theta,
        eigenvectors=((Xh, Xl) if return_device
                      else tf.dw_to_f64(Xh, Xl)[: pencil.n]),
        residuals=res,
        iterations=sweeps + 1,
        converged=bool(res.max() <= tol),
        history=hist,
    )


# --- the slab-sharded refinement ---------------------------------------------
def _dw_allsum_pairs(h, l, link=None):
    """Exact cross-slab sum of per-slab dw pairs (Dl, ...): the D pairs
    dw-added in slab order (the reference all-gathers them and does the
    same); across processes (link) both words gathered from every rank
    first, in one gather."""
    if link is not None:
        hl = link.gather(torch.stack([h, l], dim=1))
        h, l = hl[:, 0], hl[:, 1]
    ah, al = h[0], l[0]
    for d in range(1, h.shape[0]):
        ah, al = tf.dw_add(ah, al, h[d], l[d])
    return ah, al


def _slab_dot_cols(p, xh, xl, yh, yl):
    """Per-slab dw column dots of stacked (Dl n_loc_pad, m) blocks: (Dl, m)
    pairs, each slab's rows summed pairwise as tf.dw_dot_cols sums them."""
    ph, pl = tf.dw_mul(xh, xl, yh, yl)
    shape = (p.Dl, p.n_loc_pad, ph.shape[1])
    return tf.dw_sum(ph.reshape(shape), pl.reshape(shape), dim=1)


def _rq_and_residual_dist(p, Xh, Xl):
    """theta (dw), scaled residual norms, and the dw residual block of the
    stacked block. The ownership weights (0/1, exact multiplies) count
    each replicated interface row once."""
    (KXh, KXl), (MXh, MXl) = p.KM_mm_dw(Xh, Xl)
    w = p.w_dot.to(Xh.dtype)[:, None]
    nh, nl = _dw_allsum_pairs(*_slab_dot_cols(p, Xh * w, Xl * w, KXh, KXl),
                              p.link)
    dh, dl = _dw_allsum_pairs(*_slab_dot_cols(p, Xh * w, Xl * w, MXh, MXl),
                              p.link)
    th, tl = _dw_div_cols(nh, nl, dh, dl)
    tMh, tMl = tf.dw_mul(MXh, MXl, th[None, :], tl[None, :])
    Rh, Rl = tf.dw_add(KXh, KXl, -tMh, -tMl)

    def gnorm(A):
        return torch.sqrt(p._slab_sums(w * A * A))

    res = gnorm(Rh) / torch.clamp(gnorm(KXh) + torch.abs(th) * gnorm(MXh),
                                  min=1e-30)
    return th, tl, res, Rh, Rl


def _dist_grams_local(p, Xh, Xl):
    """The (m, m) dw Gram pairs X^T K X and X^T M X: per-slab pairs,
    summed across the slabs exactly."""
    (KXh, KXl), (MXh, MXl) = p.KM_mm_dw(Xh, Xl)
    w = p.w_dot.to(Xh.dtype)[:, None]
    xh_t, xl_t = (Xh * w).T, (Xl * w).T  # (m, rows)
    m = Xh.shape[1]
    out = []
    for Yh, Yl in ((KXh, KXl), (MXh, MXl)):
        cols_h, cols_l = [], []
        for j in range(m):
            ph, pl = tf.dw_mul(xh_t, xl_t, Yh[:, j][None, :],
                               Yl[:, j][None, :])
            shape = (m, p.Dl, p.n_loc_pad)
            gh, gl = tf.dw_sum(ph.reshape(shape), pl.reshape(shape), dim=2)
            cols_h.append(gh)  # (m, D)
            cols_l.append(gl)
        # (Dl, m, m) per-slab Grams, column j of slab d at [d, :, j]
        gh = torch.stack(cols_h, dim=2).transpose(0, 1)
        gl = torch.stack(cols_l, dim=2).transpose(0, 1)
        out.append(_dw_allsum_pairs(gh, gl, p.link))
    return (*out[0], *out[1])


def refine_dw_dist(
    dpencil,
    mesh,
    X,
    tol: float = 1e-8,
    max_sweeps: int = 6,
    sigma_rel: float = 3e-3,
    return_device: bool = False,
) -> EigenResult:
    """Refine approximate eigenvectors of a vacuum slab-sharded stencil
    pencil (DistStencilPencil3D with taps_dw) to `tol` relative residual on
    its device: the double-word RQI of refine_dw with dw slab tap applies,
    exact cross-slab dw sums and per-column distributed spectral shift
    solves. The host reads the (m,) residual per sweep and solves one
    (m, m) f64 eigh.

    mesh: None or the pencil's mesh (dist/mesh.py; checked against D and
    the process count: across processes every rank calls this).
    X: a host (n_full, m) block in the global stencil ordering, or an
    (n_padded, m) tensor in the stacked layout (lobpcg_dist's
    return_device: a process's own rows), used as it is. Returns the
    eigenvectors in the global ordering, reconstructed in f64 on the host
    (gathered from every rank); with return_device=True the on-device
    double-word pair (Xh, Xl) in the stacked layout, and only the (m,)
    eigenvalues and residuals come to the host."""
    from maxwell_tpu_torch.solvers.dist_solve import _check_mesh
    from maxwell_tpu_torch.solvers.spectral import DistSpectralShift

    if getattr(dpencil, "taps_dw", None) is None:
        raise ValueError("refine_dw_dist needs the vacuum slab tap pencil")
    _check_mesh(dpencil, mesh)
    device = dpencil.device
    sol = DistSpectralShift.build(dpencil, alpha=0.0, dtype=torch.float32)
    if torch.is_tensor(X) and X.dim() == 2 and (
        X.shape[0] == dpencil.n_padded
    ):
        Xh = X.to(device=device, dtype=torch.float32)  # stacked layout
    else:
        if torch.is_tensor(X):
            X = X.cpu().numpy()
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X[:, None]
        Xh = dpencil.inject_vectors(X).to(torch.float32)
    Xl = torch.zeros_like(Xh)

    mk = dpencil.mask.to(Xh.dtype)[:, None]

    def step(Xh, Xl):
        th, _, res, Rh, _ = _rq_and_residual_dist(dpencil, Xh, Xl)
        W = sol.solve_sigma(dpencil, Rh, th * (1.0 - sigma_rel)) * mk
        Xh, Xl = tf.dw_add(Xh, Xl, -W, torch.zeros_like(W))
        return Xh, Xl, res

    # the reference's trip count: at most max_sweeps (no cap of 5)
    Xh, Xl, sweeps, hist = _sweep_loop(step, Xh, Xl, max_sweeps, tol)
    Xh, Xl, theta, res = _final_rr(
        dpencil, Xh, Xl, _dist_grams_local, _rq_and_residual_dist)
    hist.append({"iter": len(hist), "max_rel_res": float(res.max())})
    vecs = (Xh, Xl) if return_device else tf.dw_to_f64(
        dpencil.extract_vectors(Xh), dpencil.extract_vectors(Xl))
    return EigenResult(
        eigenvalues=theta,
        eigenvectors=vecs,
        residuals=res,
        iterations=sweeps + 1,
        converged=bool(res.max() <= tol),
        history=hist,
    )
