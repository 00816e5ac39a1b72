"""LOBPCG block eigensolver for K x = lambda M x.

The iteration of maxwell_tpu/solvers/lobpcg.py as a Python loop over tensors
(the reference compiles it into one while_loop):
- The search basis S = [X, W, P] is M-orthonormalized by SVQB, after which
  Rayleigh-Ritz is an ordinary eigh of S^T K S. Rank-deficient basis
  columns (the empty P of iteration 0, collapsed directions near
  convergence) are masked by SVQB and pushed above the wanted spectrum by a
  diagonal shift.
- P is implicit: the Ritz step's W and P share, its coefficients taken back
  through the SVQB transform first. The reference drops the first m rows of
  the coefficients in the SVQB basis instead, where they are not X's: P
  comes out equal to the new X, SVQB masks it, and every iteration is a
  steepest-descent step on [X, W] (twice the iterations; at 24^3 in f32 it
  reaches the f32 floor before 1e-5 and bounces there).
- The gradient nullspace is projected out of the initial block and of every
  new search direction.
- In-loop soft locking (on by default, lock_tol = tol * 1e-2) freezes a
  converged cluster of tracked columns bit-exactly.
- The convergence test reads the residuals on the host once per iteration.
"""

from __future__ import annotations

import json
from typing import Callable

import numpy as np
import torch

from maxwell_tpu_torch.solvers.operator import Pencil
from maxwell_tpu_torch.solvers.results import EigenResult, merge_stages
from maxwell_tpu_torch.solvers.rr import small_eigh, svqb
from maxwell_tpu_torch.utils.precision import fp32_true


def lobpcg_run(
    pencil: Pencil,
    X0: torch.Tensor,
    maxiter: int,
    tol: float,
    precond: Callable | None = None,
    nev: int | None = None,
    Qlock: torch.Tensor | None = None,
    MQlock: torch.Tensor | None = None,
    log_every: int = 0,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    prev_iters: int = 0,
    stall_window: int = 0,
    lock_tol: float = 0.0,
    shards: int | None = None,
):
    """LOBPCG loop. X0: (n_padded, m), already projected off the nullspace
    (zero padding preserved). Convergence is tested on the first `nev`
    columns (default: all m).

    Qlock/MQlock: locked M-orthonormal eigenvectors (and M @ Qlock) to
    hard-deflate against. lock_tol > 0: in-loop soft locking — a tracked
    column whose residual reaches lock_tol (with its whole cluster) is
    frozen: X/KX/MX/theta pinned, its W and P contributions zeroed, while
    it stays in the RR basis. stall_window > 0: stop after that many
    iterations without a >= 10% improvement of the best residual and
    return the best iterate. checkpoint_every > 0 saves (X, theta, iteration)
    to checkpoint_path every that many iterations; with `shards` = D (a
    row-sharded pencil's stacked block) one file per shard,
    `{checkpoint_path}.shard{d}` (utils/checkpoint.load_sharded_state).
    Returns (theta, X, res, iters, res_hist).
    """
    n, m = X0.shape
    dtype = X0.dtype
    if nev is None:
        nev = m
    dot_mm = pencil.dot_mm

    def deflate(Z):
        if Qlock is None:
            return Z
        return Z - Qlock @ dot_mm(MQlock, Z)

    X0 = deflate(X0)
    X, MX, _, _ = svqb(X0, pencil.M_mm(X0), dot_mm=dot_mm)
    KX = pencil.K_mm(X)
    theta = pencil.dot_cols(X, KX)  # Ritz values of orthonormal X

    P = torch.zeros_like(X)
    KP = torch.zeros_like(X)
    MP = torch.zeros_like(X)
    res = torch.full((m,), float("inf"), dtype=dtype, device=X.device)
    hist = []
    # best-iterate tracking for the f32 floor regime: (best max-residual,
    # iterations since a meaningful improvement, X, theta, residuals)
    best_res, stall = float("inf"), 0
    best = (X, theta, res)
    locked = torch.zeros(m, dtype=torch.bool, device=X.device)
    tracked = torch.arange(m, device=X.device) < nev

    def residuals(KX, MX, theta):
        R = KX - MX * theta[None, :]
        loc = torch.stack(
            [
                torch.sum(KX * pencil.weigh(KX), dim=0),
                torch.sum(MX * pencil.weigh(MX), dim=0),
                torch.sum(R * pencil.weigh(R), dim=0),
            ]
        )
        nKX, nMX, nR = torch.sqrt(torch.clamp(pencil.reduce_rows(loc), min=0.0))
        scale = nKX + torch.abs(theta) * nMX
        return R, nR / torch.clamp(scale, min=1e-30)

    it = 0
    cur = float("inf")
    while it < maxiter and cur > tol:
        if stall_window > 0 and stall >= stall_window:
            break
        R, _ = residuals(KX, MX, theta)
        W = precond(R) if precond is not None else R
        W = pencil.project(W)
        W = deflate(W)
        W = W - X @ dot_mm(MX, W)  # cheap X-deflation: better Gram conditioning
        if lock_tol > 0.0:
            W = W * (~locked).to(dtype)[None, :]

        KW, MW = pencil.KM_mm(W)

        S = torch.cat([X, W, P], dim=1)  # (n, 3m)
        KS = torch.cat([KX, KW, KP], dim=1)
        MS = torch.cat([MX, MW, MP], dim=1)
        # M-orthonormalize the basis (dead columns masked) and rotate KS by
        # the same transform — no extra SpMM
        Q, MQ, good, T = svqb(S, MS, dot_mm=dot_mm)
        KQ = KS @ T

        A = dot_mm(Q, KQ)
        A = 0.5 * (A + A.T)
        # push SVQB-masked columns above the wanted spectrum; the shift
        # stays moderate relative to ||A|| (stored in the working dtype) so
        # the eigh keeps the small ones
        dead_shift = 10.0 * torch.max(torch.abs(torch.diagonal(A))) + 1.0
        A = A + torch.diag(torch.where(good, 0.0, dead_shift).to(dtype))
        thetaS, C = small_eigh(A)
        Cx = C[:, :m]  # smallest m Ritz pairs
        theta_new = thetaS[:m]

        X_new = Q @ Cx
        KX_new = KQ @ Cx
        MX_new = MQ @ Cx

        # implicit P: the Ritz step without its X share. SVQB mixes the
        # blocks, so the coefficients go back to [X, W, P] (T @ Cx) before
        # X's rows are dropped
        Cp = (T @ Cx)[m:]
        P_new = S[:, m:] @ Cp
        KP_new = KS[:, m:] @ Cp
        MP_new = MS[:, m:] @ Cp

        if lock_tol > 0.0:
            # pin frozen columns bit-exactly (they stay in the RR basis, so
            # active Ritz vectors come out M-orthogonal against them)
            lk = locked[None, :]
            X_new = torch.where(lk, X, X_new)
            KX_new = torch.where(lk, KX, KX_new)
            MX_new = torch.where(lk, MX, MX_new)
            theta_new = torch.where(locked, theta, theta_new)

        _, res_new = residuals(KX_new, MX_new, theta_new)
        if lock_tol > 0.0:
            ready = res_new <= lock_tol
            # cluster-aware gate: lock a degenerate cluster only as a whole
            # (pinning one member while its siblings rotate destroys their
            # mutual M-orthogonality)
            th_scale = torch.clamp(torch.max(torch.abs(theta_new)), min=1e-30)
            close = (
                torch.abs(theta_new[:, None] - theta_new[None, :])
                <= 1e-3 * th_scale
            )
            cluster_ok = ~torch.any(close & ~ready[:, None], dim=0)
            newly = ready & cluster_ok & tracked
            if Qlock is not None:
                # a column drifting onto a hard-deflated pair has a small
                # residual but must not lock: gate on the M-overlap
                defect = torch.linalg.norm(dot_mm(MQlock, X_new), dim=0)
                newly = newly & (defect <= 1e-3)
            locked = locked | newly
            act = (~locked).to(dtype)[None, :]
            P_new = P_new * act
            KP_new = KP_new * act
            MP_new = MP_new * act

        cur = float(torch.max(res_new[:nev]))  # the per-iteration host sync
        hist.append(cur)
        # best iterate: near the f32 floor the iterate bounces; keep the
        # best block and count iterations without a >= 10% improvement
        if cur < 0.9 * best_res:
            best_res, stall = cur, 0
            best = (X_new, theta_new, res_new)
        else:
            stall += 1
        if log_every > 0 and it % log_every == 0:
            print(
                json.dumps(
                    {
                        "iter": it,
                        "max_rel_res": cur,
                        "theta_min": float(theta_new[0]),
                    }
                ),
                flush=True,
            )
        if (
            checkpoint_every > 0
            and checkpoint_path is not None
            and (it + 1) % checkpoint_every == 0
        ):
            from maxwell_tpu_torch.utils.checkpoint import save_state

            Xh, th = X_new.cpu().numpy(), theta_new.cpu().numpy()
            if shards is None:
                save_state(checkpoint_path, X=Xh, theta=th,
                           iteration=prev_iters + it + 1)
            else:
                for d, Xd in enumerate(np.split(Xh, shards)):
                    save_state(f"{checkpoint_path}.shard{d}", X=Xd, theta=th,
                               iteration=prev_iters + it + 1)
        X, KX, MX, theta = X_new, KX_new, MX_new, theta_new
        P, KP, MP = P_new, KP_new, MP_new
        res = res_new
        it += 1

    # floor-bounce regime (stall_window > 0 opts in): return the BEST
    # iterate seen, not the last
    if stall_window > 0 and best_res < float(torch.max(res[:nev])):
        X, theta, res = best
    return theta, X, res, it, hist


@fp32_true
def lobpcg(
    pencil: Pencil,
    nev: int = 5,
    m: int | None = None,
    maxiter: int = 200,
    tol: float = 1e-8,
    generator: torch.Generator | None = None,
    precond: Callable | None = None,
    X0: torch.Tensor | np.ndarray | None = None,
    checkpoint: str | None = None,
    checkpoint_every: int = 0,
    deflate_Q: torch.Tensor | np.ndarray | None = None,
    log_every: int = 0,
    stall_window: int = 0,
    batch: int | None = None,
    lock: bool = True,
    return_device: bool = False,
) -> EigenResult:
    """Solve for the `nev` smallest nonzero eigenpairs of K x = lambda M x.

    m: block size (default nev + max(4, nev//2) guard vectors); the result
    keeps the first nev. generator: torch.Generator for the random start
    block (default: seed 0 on the pencil's device). X0: starting block,
    (n, m) or (n_padded, m); it is zero-padded to n_padded.
    checkpoint: state file — resumes X0 from it if present, saves the final
    Ritz block to it (and every checkpoint_every iterations).
    deflate_Q: (n, q) converged M-orthonormal eigenvectors to hard-deflate;
    the solve returns the next nev pairs above them.
    log_every: print a JSON progress line every that many iterations.
    stall_window: if > 0, stop after that many iterations without a >= 10%
    improvement of the best residual and return the best iterate (the f32
    floor cut-off before f64 refinement).
    lock: in-loop soft locking (lock_tol = tol * 1e-2). Output pairs are
    re-sorted ascending on exit.
    batch < nev: solve in stages of `batch` pairs, each stage's block
    hard-deflated from the next (per-iteration cost drops as pairs lock);
    stage s draws its start block from `generator` (default: seed s on the
    pencil's device); X0 and checkpoint are not used there, as in the
    reference.
    return_device: keep the eigenvector block on the pencil's device:
    eigenvectors is the (n_padded, nev) tensor X[:, :nev] in the padded
    layout (the best iterate where the stall cut took it), the handoff
    refine_dw takes without a copy through the host. Eigenvalues and
    residuals stay numpy. The staged `batch` path ignores it: its stages
    join on the host.
    """
    if batch is not None and batch < nev:
        return _lobpcg_staged(
            pencil, nev, batch, maxiter, tol, generator, precond, deflate_Q,
            log_every, stall_window, lock)
    if m is None:
        m = nev + max(4, nev // 2)
    n_pad, n = pencil.n_padded, pencil.n
    dtype, device = pencil.dtype, pencil.device

    def padded(Z, width):
        Z = torch.as_tensor(Z, dtype=dtype).to(device)
        if Z.shape not in ((n, width), (n_pad, width)):
            raise ValueError(
                f"block must be ({n}, {width}) or ({n_pad}, {width}), "
                f"got {tuple(Z.shape)}"
            )
        out = torch.zeros((n_pad, width), dtype=dtype, device=device)
        out[:n] = Z[:n]
        return out

    prev_iters = 0
    if X0 is None and checkpoint is not None:
        from maxwell_tpu_torch.utils.checkpoint import load_state

        state = load_state(checkpoint)
        # accept both exit-time (n, m) and in-loop (n_pad, m) snapshots
        if state is not None and state["X"].shape in ((n, m), (n_pad, m)):
            X0 = state["X"]
            prev_iters = state["iteration"]
    if X0 is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        X0 = torch.randn(
            (n_pad, m), generator=generator, dtype=dtype, device=device
        )
    X0 = pencil.project(padded(X0, m))

    Qlock = MQlock = None
    if deflate_Q is not None:
        Qlock = padded(deflate_Q, deflate_Q.shape[1])
        MQlock = pencil.M_mm(Qlock)

    theta, X, res, it, hist = lobpcg_run(
        pencil, X0, maxiter, tol, precond, nev=nev,
        Qlock=Qlock, MQlock=MQlock, log_every=log_every,
        checkpoint_every=checkpoint_every if checkpoint else 0,
        checkpoint_path=checkpoint, prev_iters=prev_iters,
        stall_window=stall_window, lock_tol=tol * 1e-2 if lock else 0.0,
    )
    # ascending order of the tracked pairs (with locking a frozen column
    # can be overtaken by a smaller late pair)
    theta_h = theta.cpu().numpy()
    order = np.argsort(theta_h[:nev])
    if not np.all(order == np.arange(nev)):
        idx = torch.as_tensor(order, device=device)
        theta, X, res = theta.clone(), X.clone(), res.clone()
        theta[:nev] = theta[idx]
        X[:, :nev] = X[:, idx]
        res[:nev] = res[idx]

    if checkpoint is not None:
        from maxwell_tpu_torch.utils.checkpoint import save_state

        save_state(
            checkpoint,
            X=X[:n].cpu().numpy(),
            theta=theta.cpu().numpy(),
            iteration=prev_iters + it,
        )

    res_h = res.cpu().numpy()[:nev]
    return EigenResult(
        eigenvalues=theta.cpu().numpy()[:nev],
        eigenvectors=(X[:, :nev].contiguous() if return_device
                      else X[:n, :nev].cpu().numpy()),
        residuals=res_h,
        iterations=prev_iters + it,
        converged=bool(res_h.max() <= tol),
        history=[
            {"iter": prev_iters + i, "max_rel_res": h}
            for i, h in enumerate(hist)
        ],
    )


def _lobpcg_staged(pencil, nev, batch, maxiter, tol, generator, precond,
                   deflate_Q, log_every, stall_window, lock) -> EigenResult:
    """The staged `batch` path (maxwell_tpu/solvers/lobpcg.py:392-431)."""
    Q = None if deflate_Q is None else np.asarray(
        deflate_Q.cpu() if torch.is_tensor(deflate_Q) else deflate_Q)
    vals, vecs, resids, hist = [], [], [], []
    iters = done = stage = 0
    while done < nev:
        k = min(batch, nev - done)
        gen = generator
        if gen is None:
            gen = torch.Generator(device=pencil.device).manual_seed(stage)
        r = lobpcg(pencil, nev=k, maxiter=maxiter, tol=tol, generator=gen,
                   precond=precond, deflate_Q=Q, log_every=log_every,
                   stall_window=stall_window, lock=lock)
        vals.append(r.eigenvalues)
        vecs.append(r.eigenvectors)
        resids.append(r.residuals)
        hist.extend({**h, "iter": iters + h["iter"], "stage": stage}
                    for h in r.history)
        iters += r.iterations
        Q = (r.eigenvectors if Q is None
             else np.concatenate([Q, r.eigenvectors], axis=1))
        done += k
        stage += 1
    return merge_stages(vals, vecs, resids, iters, hist, tol)
