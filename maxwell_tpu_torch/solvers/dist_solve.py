"""Distributed solvers (maxwell_tpu/solvers/dist_solve.py): the
single-device LOBPCG and Lanczos loops run unchanged on a row-sharded
DistPencil or a slab-sharded DistStencilPencil3D, whose stacked views
supply the per-shard reductions and the halo or ghost-plane exchanges —
device count really is a mesh property.

The reference shard_maps its loops over a JAX device mesh; here the shards
live in one process, or a DistPencil's in P processes (dist/procs.py), each
running these loops on its own shards in step, so a mesh argument only
names the shard and process counts and is checked against the pencil.
Start blocks and vectors are in the pencil's stacked layout (a DistPencil's
rows in its RCM order, zero past row n; a DistStencilPencil3D's slabs), as
the reference's `make_block` draws them: a numpy array is the whole block
(every rank keeps its own rows), and across processes a tensor of
n_padded rows is this process's rows already (what `make_block` and
`inject_vectors` return). Eigenvectors come back in the problem's own
ordering (`extract_vectors`, gathered from every rank), or, with
`return_device`, stay on the device in the stacked layout (a rank's own
rows).

Across processes every host decision is taken on replicated values: the
reductions' sums, the Ritz values, MINRES's residual; and a checkpoint's
resume is decided by rank 0 and handed to every rank.
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


def _procs(dpencil) -> int:
    return getattr(dpencil, "procs", 1)


def _check_mesh(dpencil: DistPencil, mesh) -> None:
    if mesh is not None and (mesh.D, mesh.procs) != (dpencil.D,
                                                     _procs(dpencil)):
        raise ValueError(
            f"mesh has {mesh.D} shards over {mesh.procs} processes, the "
            f"pencil {dpencil.D} over {_procs(dpencil)}")


def _stacked(dpencil: DistPencil, X, width: int) -> torch.Tensor:
    """A block in the stacked layout, (global_rows, width) or (n, width),
    zero past row n, on the pencil's device: this process's rows. Across
    processes a tensor of (n_padded, width) is this process's rows already
    (a pencil's make_block or inject_vectors) and is taken as it is; a
    numpy array is always the whole block."""
    rows = torch.is_tensor(X) and _procs(dpencil) > 1
    if not torch.is_tensor(X):
        X = torch.from_numpy(np.array(X))  # a writable copy
    X = X.to(dtype=dpencil.dtype, device=dpencil.device)
    if X.dim() == 1:
        X = X[:, None]
    if rows and X.shape == (dpencil.n_padded, width):
        return X
    if X.shape not in ((dpencil.n, width), (dpencil.global_rows, width)):
        raise ValueError(
            f"block must be ({dpencil.n}, {width}) or "
            f"({dpencil.global_rows}, {width}), got {tuple(X.shape)}")
    out = torch.zeros((dpencil.global_rows, width), dtype=dpencil.dtype,
                      device=dpencil.device)
    out[: dpencil.n] = X[: dpencil.n]
    return out if _procs(dpencil) == 1 else dpencil.local(out)


def _group(dpencil):
    """The rank group of a pencil across processes, else None."""
    return None if dpencil.link is None else dpencil.link.group


def _resume(dpencil, path: str, m: int):
    """(X0, iteration) of a resume from the checkpoint `path`: the
    exit-time file (the problem's ordering, any D and P) when its block is
    m wide, else the in-loop shard files of the pencil's D shards (the
    stacked layout, any P that divides D) when every one is there and m
    wide, else (None, 0), a fresh start. Across processes rank 0 looks and
    decides, and every rank takes its decision: the same file and the same
    iteration (the oldest of the shard files'); then each rank reads it and
    keeps its own rows."""
    from maxwell_tpu_torch.utils.checkpoint import (
        load_sharded_state,
        load_state,
    )

    group = _group(dpencil)
    choice = (None, 0)
    if group is None or group.rank == 0:
        state = load_state(path)
        if state is not None and state["X"].shape[1] == m:
            choice = ("exit", state["iteration"])
        else:
            sstate = load_sharded_state(path, dpencil.D)
            if sstate is not None and sstate["X"].shape[1] == m:
                choice = ("shards", sstate["iteration"])
    if group is not None:
        choice = group.all_gather_object(choice)[0]
    kind, iteration = choice
    if kind == "exit":
        return dpencil.inject_vectors(load_state(path)["X"]), iteration
    if kind == "shards":
        sstate = load_sharded_state(path, dpencil.D)
        if sstate is None:
            raise FileNotFoundError(f"{path}.shard*: a shard file went "
                                    "missing during the resume")
        return _stacked(dpencil, sstate["X"], m), iteration
    return None, 0


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

    checkpoint: resume from / save the Ritz block. The exit-time file holds
    vectors in the problem's ordering, so it resumes at any shard count D
    and any process count P; across processes every rank gathers the
    block, rank 0 alone writes it (atomic rename), and a barrier follows,
    so every rank sees it once lobpcg_dist returns. checkpoint_every > 0
    also writes per-shard snapshots `{checkpoint}.shard{d}`, d = 0 ... D -
    1, every k iterations, each rank its own shards' files, so P ranks
    write the files one process writes; a resume reassembles them when the
    exit-time file is missing (or of another width). They hold the stacked
    layout of the D shards or slabs, which does not depend on P: they
    resume at any P that divides D, one process included, but not at
    another D. Across processes rank 0 decides which file a resume takes,
    and at which iteration, and every rank follows (`_resume`). The staged
    path takes no checkpoint.
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
    X0: start block in the stacked layout, whole or (across processes)
    this process's rows (default: make_block from `generator`, seed 0 on
    the pencil's device).
    return_device: eigenvectors is the stacked (n_padded, nev) tensor on
    the pencil's device (across processes the rank's own rows), the layout
    refine_dw_dist takes without a copy through the host; eigenvalues and
    residuals stay numpy. The staged path ignores it.
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
        X0, prev_iters = _resume(dpencil, checkpoint, m)
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
        shards=range(dpencil.d0, dpencil.d0 + dpencil.Dl),
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

        Xh = dpencil.extract_vectors(X)  # a gather on every rank
        group = _group(dpencil)
        if group is None or group.rank == 0:
            save_state(checkpoint, X=Xh, theta=theta.cpu().numpy(),
                       iteration=prev_iters + it)
        if group is not None:
            group.barrier()
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


def start_rows(dpencil, v0=None, generator: torch.Generator | None = None):
    """The start vector of a distributed Krylov solve as this process's
    (n_padded,) stacked rows: v0 taken as `_stacked` takes a block (a
    numpy vector whole; across processes a tensor of n_padded rows as the
    rank's), or make_block(1) from `generator`."""
    if v0 is None:
        return dpencil.make_block(1, generator)[:, 0]
    return _stacked(dpencil, v0, 1)[:, 0]


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
    loop on the stacked pencil. v0: start vector in the stacked layout,
    whole or this process's rows as `_stacked` takes them (default:
    make_block(1) from `generator`)."""
    from maxwell_tpu_torch.solvers.lanczos import lanczos

    _check_mesh(dpencil, mesh)
    res = lanczos(dpencil, nev=nev, maxiter=maxiter, tol=tol,
                  v0=start_rows(dpencil, v0, generator), return_device=True)
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
    on the row-sharded DistPencil and the slab-sharded DistStencilPencil3D,
    in one process or across processes, where every rank runs the same
    MINRES steps on its rows (its stopping test reads a reduced scalar).
    v0: start vector in the stacked layout, whole or this process's rows
    as `_stacked` takes them (default: make_block(1) from `generator`)."""
    from maxwell_tpu_torch.solvers.lanczos import lanczos
    from maxwell_tpu_torch.solvers.shift_invert import iterative_apply

    _check_mesh(dpencil, mesh)
    res = lanczos(
        dpencil, nev=nev, maxiter=maxiter, tol=tol,
        v0=start_rows(dpencil, v0, generator),
        mode="shift_invert",
        apply_op=iterative_apply(dpencil, sigma, inner_tol, inner_iters),
        sigma=sigma, return_device=True,
    )
    res.eigenvectors = dpencil.extract_vectors(res.eigenvectors)
    return res


def spmm_dist(dpencil: DistPencil, mesh, X, which: str = "K"):
    """Sharded Y = K @ X (or M @ X) for a stacked X (global_rows, m), or
    across processes a rank's own rows (n_padded, m); Y the rank's rows."""
    _check_mesh(dpencil, mesh)
    if which not in ("K", "M"):
        raise ValueError(f"which must be 'K' or 'M', got {which!r}")
    if not torch.is_tensor(X):
        X = torch.from_numpy(np.array(X))
    X = X.to(dtype=dpencil.dtype, device=dpencil.device)
    if _procs(dpencil) > 1 and X.shape[0] == dpencil.global_rows:
        X = dpencil.local(X)
    return dpencil.K_mm(X) if which == "K" else dpencil.M_mm(X)
