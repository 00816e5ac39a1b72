"""Distributed solvers (maxwell_tpu/solvers/dist_solve.py): the
single-device LOBPCG and Lanczos loops run unchanged on a row-sharded
DistPencil or a slab-sharded DistStencilPencil3D, whose stacked views
supply the per-shard reductions and the halo or ghost-plane exchanges —
device count really is a mesh property.

The reference shard_maps its loops over a JAX device mesh; here all shards
live on one device (dist/mesh.py), so a mesh argument only names the shard
count and is checked against the pencil. Start blocks are in the pencil's
stacked layout (a DistPencil's rows in its RCM order, zero past row n; a
DistStencilPencil3D's slabs), as the reference's `make_block` draws them;
eigenvectors come back in the problem's own ordering (`extract_vectors`),
or, with `return_device`, stay on the device in the stacked layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from maxwell_tpu_torch.dist.partition import DistPencil
from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
from maxwell_tpu_torch.solvers.lobpcg import lobpcg_run
from maxwell_tpu_torch.solvers.results import EigenResult, merge_stages
from maxwell_tpu_torch.utils.precision import fp32_true


def _spectral_serves(dpencil) -> bool:
    """Whether "auto" takes the distributed spectral preconditioner: a
    vacuum slab-sharded stencil pencil."""
    return (isinstance(dpencil, DistStencilPencil3D)
            and dpencil.inv_mu is None and dpencil.eps is None)


def _check_mesh(dpencil: DistPencil, mesh) -> None:
    if mesh is not None and mesh.D != dpencil.D:
        raise ValueError(
            f"mesh has {mesh.D} shards, the pencil {dpencil.D}")


def _stacked(dpencil: DistPencil, X, width: int) -> torch.Tensor:
    """A block in the stacked layout, (global_rows, width) or (n, width),
    zero past row n, on the pencil's device."""
    if not torch.is_tensor(X):
        X = torch.from_numpy(np.array(X))  # a writable copy
    X = X.to(dtype=dpencil.dtype, device=dpencil.device)
    if X.dim() == 1:
        X = X[:, None]
    if X.shape not in ((dpencil.n, width), (dpencil.global_rows, width)):
        raise ValueError(
            f"block must be ({dpencil.n}, {width}) or "
            f"({dpencil.global_rows}, {width}), got {tuple(X.shape)}")
    out = torch.zeros((dpencil.global_rows, width), dtype=dpencil.dtype,
                      device=dpencil.device)
    out[: dpencil.n] = X[: dpencil.n]
    return out


def host_vectors(dpencil, vecs) -> np.ndarray:
    """Eigenvectors of a distributed result as a host array in the
    problem's ordering: a host array as it is, a stacked device block
    extracted, a stacked double-word pair (refine_dw_dist's
    return_device) extracted word by word and summed in f64."""
    if isinstance(vecs, tuple):
        from maxwell_tpu_torch.utils.twofloat import dw_to_f64

        return dw_to_f64(*(dpencil.extract_vectors(v) for v in vecs))
    if torch.is_tensor(vecs):
        return dpencil.extract_vectors(vecs)
    return vecs


@fp32_true
def lobpcg_dist(
    dpencil: DistPencil,
    mesh=None,
    nev: int = 5,
    m: int | None = None,
    maxiter: int = 200,
    tol: float = 1e-8,
    generator: torch.Generator | None = None,
    precond_alpha: float | None = None,
    precond_iters: int = 20,
    checkpoint: str | None = None,
    checkpoint_every: int = 0,
    precond: str = "auto",
    deflate_Q: np.ndarray | None = None,
    batch: int | None = None,
    stall_window: int = 0,
    lock: bool = True,
    stage_polish=None,
    X0=None,
    log_every: int = 0,
    return_device: bool = False,
) -> EigenResult:
    """Distributed LOBPCG on a row-sharded pencil. Returns a host
    EigenResult with eigenvectors in the problem's ordering.

    checkpoint: resume from / save the Ritz block — the exit-time file holds
    vectors in the problem's ordering (portable across shard counts);
    checkpoint_every > 0 also writes per-shard snapshots `{checkpoint}
    .shard{d}` every k iterations, which a resume reassembles when the
    exit-time file is missing.
    precond: "auto" takes the exact distributed spectral (K + alpha M)^-1
    (solvers/spectral.DistSpectralShift, alpha = precond_alpha or 15.0) on
    a vacuum slab-sharded stencil pencil (DistStencilPencil3D), chosen by
    the pencil's type, and otherwise the shifted-CG sweeps when
    precond_alpha is given; "cg" forces the sweeps; "spectral" requires the
    spectral solve and raises where DistSpectralShift.build does.
    deflate_Q: (n, q) converged eigenvectors in the problem's ordering to
    hard-deflate. batch < nev: solve in stages of `batch` pairs, each
    stage's block hard-deflated from the next; stage_polish: a hook
    EigenResult -> EigenResult applied to each stage's block first.
    X0: start block in the stacked layout (default: make_block from
    `generator`, seed 0 on the pencil's device).
    return_device: eigenvectors is the stacked (global_rows, nev) tensor on
    the pencil's device, the layout refine_dw_dist takes without a copy
    through the host; eigenvalues and residuals stay numpy. The staged
    path ignores it.
    """
    _check_mesh(dpencil, mesh)
    if precond not in ("auto", "cg", "spectral"):
        raise ValueError(f"unknown precond {precond!r}")
    if batch is not None and batch < nev:
        return _lobpcg_dist_staged(
            dpencil, nev=nev, batch=batch, m=m, maxiter=maxiter, tol=tol,
            generator=generator, precond_alpha=precond_alpha,
            precond_iters=precond_iters, precond=precond, deflate_Q=deflate_Q,
            stall_window=stall_window, stage_polish=stage_polish, lock=lock,
            log_every=log_every,
        )
    if m is None:
        m = nev + max(4, nev // 2)
    prev_iters = 0
    if X0 is None and checkpoint is not None:
        from maxwell_tpu_torch.utils.checkpoint import (
            load_sharded_state,
            load_state,
        )

        state = load_state(checkpoint)
        if state is not None and state["X"].shape[1] == m:
            X0 = dpencil.inject_vectors(state["X"])
            prev_iters = state["iteration"]
        else:
            # the in-loop per-shard snapshots (stacked layout)
            sstate = load_sharded_state(checkpoint, dpencil.D)
            if sstate is not None and sstate["X"].shape[1] == m:
                X0 = sstate["X"]
                prev_iters = sstate["iteration"]
    X0 = (dpencil.make_block(m, generator) if X0 is None
          else _stacked(dpencil, X0, m))
    X0 = dpencil.project(X0)

    pc = None
    if precond == "spectral" or (precond == "auto"
                                 and _spectral_serves(dpencil)):
        from maxwell_tpu_torch.solvers.spectral import DistSpectralShift

        sol = DistSpectralShift.build(
            dpencil, 15.0 if precond_alpha is None else precond_alpha)
        pc = functools.partial(sol.solve, dpencil)
    elif precond_alpha is not None:
        from maxwell_tpu_torch.solvers.precond import (
            shifted_cg_preconditioner,
        )

        pc = shifted_cg_preconditioner(dpencil, precond_alpha, precond_iters)
    Qlock = MQlock = None
    if deflate_Q is not None:
        Qlock = dpencil.inject_vectors(np.asarray(deflate_Q))
        MQlock = dpencil.M_mm(Qlock)

    theta, X, res, it, hist = lobpcg_run(
        dpencil, X0, maxiter, tol, pc, nev=nev, Qlock=Qlock, MQlock=MQlock,
        log_every=log_every,
        checkpoint_every=checkpoint_every if checkpoint else 0,
        checkpoint_path=checkpoint, prev_iters=prev_iters,
        stall_window=stall_window, lock_tol=tol * 1e-2 if lock else 0.0,
        shards=dpencil.D,
    )
    # ascending order of the tracked pairs (a frozen column can be
    # overtaken by a smaller late pair)
    order = np.argsort(theta.cpu().numpy()[:nev])
    if not np.all(order == np.arange(nev)):
        idx = torch.as_tensor(order, device=X.device)
        theta, X, res = theta.clone(), X.clone(), res.clone()
        theta[:nev], X[:, :nev], res[:nev] = theta[idx], X[:, idx], res[idx]

    if checkpoint is not None:
        from maxwell_tpu_torch.utils.checkpoint import save_state

        save_state(checkpoint, X=dpencil.extract_vectors(X),
                   theta=theta.cpu().numpy(), iteration=prev_iters + it)
    res_h = res[:nev].cpu().numpy()
    return EigenResult(
        eigenvalues=theta[:nev].cpu().numpy(),
        eigenvectors=(X[:, :nev].contiguous() if return_device
                      else dpencil.extract_vectors(X[:, :nev])),
        residuals=res_h,
        iterations=prev_iters + it,
        converged=bool(res_h.max() <= tol),
        history=[{"iter": prev_iters + i, "max_rel_res": h}
                 for i, h in enumerate(hist)],
    )


def _lobpcg_dist_staged(dpencil, nev, batch, m, maxiter, tol, generator,
                        precond_alpha, precond_iters, precond, deflate_Q,
                        stall_window=0, stage_polish=None, lock=True,
                        log_every=0):
    """Incremental deflated multi-eigenpair solve: stage s solves the next
    `batch` pairs with every earlier stage's block hard-deflated, so the
    active block is `batch + guards` wide instead of `nev + guards`. Each
    stage draws its start block from `generator` (default: seed s on the
    pencil's device) and takes the caller's `precond`."""
    Q = None if deflate_Q is None else np.asarray(deflate_Q)
    vals, vecs, resids, hist = [], [], [], []
    iters = done = stage = 0
    while done < nev:
        k = min(batch, nev - done)
        gen = generator
        if gen is None:
            gen = torch.Generator(device=dpencil.device).manual_seed(stage)
        res = lobpcg_dist(
            dpencil, nev=k, m=None if m is None else min(m, k + 4),
            maxiter=maxiter, tol=tol, generator=gen,
            precond_alpha=precond_alpha, precond_iters=precond_iters,
            precond=precond, deflate_Q=Q, stall_window=stall_window, lock=lock,
            log_every=log_every,
        )
        if stage_polish is not None:
            res = stage_polish(res)
        vals.append(res.eigenvalues)
        vecs.append(host_vectors(dpencil, res.eigenvectors))
        resids.append(res.residuals)
        hist.extend({**h, "iter": iters + h["iter"], "stage": stage}
                    for h in res.history)
        iters += res.iterations
        Q = (vecs[-1] if Q is None
             else np.concatenate([Q, vecs[-1]], axis=1))
        done += k
        stage += 1
    return merge_stages(vals, vecs, resids, iters, hist, tol)


@fp32_true
def lanczos_dist(
    dpencil: DistPencil,
    mesh=None,
    nev: int = 5,
    maxiter: int = 100,
    tol: float = 1e-8,
    v0=None,
    generator: torch.Generator | None = None,
) -> EigenResult:
    """Distributed direct-mode Lanczos: the single-device factorization
    loop on the stacked pencil. v0: start vector in the stacked layout
    (default: make_block(1) from `generator`)."""
    from maxwell_tpu_torch.solvers.lanczos import lanczos

    _check_mesh(dpencil, mesh)
    if v0 is None:
        v0 = dpencil.make_block(1, generator)[:, 0]
    res = lanczos(dpencil, nev=nev, maxiter=maxiter, tol=tol, v0=v0)
    res.eigenvectors = dpencil.extract_vectors(res.eigenvectors)
    return res


@fp32_true
def shift_invert_lanczos_dist(
    dpencil,
    mesh=None,
    sigma: float = 0.0,
    nev: int = 5,
    maxiter: int = 60,
    tol: float = 1e-8,
    v0=None,
    generator: torch.Generator | None = None,
    inner_tol: float = 1e-11,
    inner_iters: int = 400,
) -> EigenResult:
    """Distributed shift-invert Lanczos (maxwell_tpu/solvers/dist_solve.py:
    374-432): the single-device Lanczos on the stacked pencil with the
    matrix-free MINRES apply (solvers/shift_invert.py), whose every inner
    step is a sharded K/M apply and per-shard dots. No factorization: works
    on the row-sharded DistPencil and the slab-sharded DistStencilPencil3D.
    v0: start vector in the stacked layout (default: make_block(1) from
    `generator`)."""
    from maxwell_tpu_torch.solvers.lanczos import lanczos
    from maxwell_tpu_torch.solvers.shift_invert import iterative_apply

    _check_mesh(dpencil, mesh)
    if v0 is None:
        v0 = dpencil.make_block(1, generator)[:, 0]
    res = lanczos(
        dpencil, nev=nev, maxiter=maxiter, tol=tol, v0=v0,
        mode="shift_invert",
        apply_op=iterative_apply(dpencil, sigma, inner_tol, inner_iters),
        sigma=sigma,
    )
    res.eigenvectors = dpencil.extract_vectors(res.eigenvectors)
    return res


def spmm_dist(dpencil: DistPencil, mesh, X, which: str = "K"):
    """Sharded Y = K @ X (or M @ X) for a stacked X (global_rows, m)."""
    _check_mesh(dpencil, mesh)
    if which not in ("K", "M"):
        raise ValueError(f"which must be 'K' or 'M', got {which!r}")
    if not torch.is_tensor(X):
        X = torch.from_numpy(np.array(X))
    X = X.to(dtype=dpencil.dtype, device=dpencil.device)
    return dpencil.K_mm(X) if which == "K" else dpencil.M_mm(X)
