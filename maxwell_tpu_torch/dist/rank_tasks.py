"""What the ranks of a spawn run (dist/procs.py): the row-sharded pencil's
exchanges, applies, reductions and solves on P processes, each result
gathered to the whole problem, so a caller can hold P processes to one.

Each task is called as `spawn(task, P, ...)`, or directly in one process
with procs=1; both return the same structure (rank 0's, which every rank
holds), of host arrays. The tasks live in the package because a spawned
rank imports the module of its target function, which must import no more
than the port.

    apply_checks(spec, D, procs, device, cases, widths, seed)
    solve_checks(spec, D, procs, device, kernel, halo_impl, dtype, runs)
    exchange_bench(spec, D, procs, widths, seed, reps)   (the card)
    cli(argv)                                            (cli/run.py)
    sequence(calls)                                      several in one spawn
    raise_on(rank, message)                              the failure drill
"""

from __future__ import annotations

import time

import numpy as np
import torch

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def build_problem(spec):
    """("brick", n): the n^3 BrickCavity3D; ("rect", n): the n x n
    RectCavity2D."""
    from maxwell_tpu_torch.problems import BrickCavity3D, RectCavity2D

    kind, n = spec
    if kind == "brick":
        return BrickCavity3D(nx=n, ny=n, nz=n)
    if kind == "rect":
        return RectCavity2D(nx=n, ny=n)
    raise ValueError(f"unknown problem {spec!r}")


def pencil(spec, D, procs, device, kernel, halo_impl, dtype):
    """(mesh, the row-sharded pencil of `spec` on it): this rank's shards."""
    from maxwell_tpu_torch.dist import make_mesh, partition_problem

    mesh = make_mesh(D, device, procs)
    dp = partition_problem(build_problem(spec), D, kernel=kernel,
                           dtype=DTYPES[dtype], halo_impl=halo_impl,
                           mesh=mesh)
    return mesh, dp


def whole(dp, T: torch.Tensor) -> np.ndarray:
    """Every rank's rows of T, stacked, on the host."""
    T = T.detach()
    if dp.link is not None:
        T = dp.link.gather(T)
    return T.cpu().numpy()


def block(dp, m: int, seed: int) -> torch.Tensor:
    """This rank's rows of a global (global_rows, m) normal block drawn
    with numpy from `seed`, zero past row n."""
    X = np.random.default_rng(seed).standard_normal((dp.global_rows, m))
    X[dp.n:] = 0.0
    return dp.local(torch.from_numpy(X)).to(dp.device, dp.dtype)


def _kernel_counts() -> dict:
    from maxwell_tpu_torch.kernels import bsr_spmm, halo, spmm

    return {k: v for mod in (spmm, bsr_spmm, halo)
            for k, v in mod.counts().items()}


def _reset_counts() -> None:
    from maxwell_tpu_torch.kernels import bsr_spmm, halo, spmm

    for mod in (spmm, bsr_spmm, halo):
        mod.reset_counts()


def apply_checks(spec, D, procs, device, cases, widths=(1, 3), seed=0):
    """For each case (kernel, halo_impl, dtype) and width m: the halo
    buffers ([own | left | right | pad] and [left | right]), the K, M and
    fused applies, the fused interior SpMM + halo section where the union
    pencil takes it, the reductions (dot_mm, dot_cols, col_norms, dot_vv,
    dot_basis) and the projection, on blocks drawn from `seed`.
    {(kernel, halo_impl, dtype): {m: {name: array}}}."""
    from maxwell_tpu_torch.kernels import halo

    out = {}
    for kernel, impl, dtype in cases:
        _, dp = pencil(spec, D, procs, device, kernel, impl, dtype)
        res = {}
        for m in widths:
            X, Y = block(dp, m, seed + m), block(dp, m, seed + 100 + m)
            r = {
                "halo_own": whole(dp, dp.exchange_halos(X)),
                "halo_lr": whole(dp, dp._exchange(X, False, 0).clone()),
                "K": whole(dp, dp.K_mm(X)),
                "M": whole(dp, dp.M_mm(X)),
                "KM": np.stack([whole(dp, Z) for Z in dp.KM_mm(X)]),
                "dot_mm": dp.dot_mm(X, Y).cpu().numpy(),
                "dot_cols": dp.dot_cols(X, Y).cpu().numpy(),
                "col_norms": dp.col_norms(X).cpu().numpy(),
                "dot_vv": dp.dot_vv(X[:, 0], Y[:, 0]).cpu().numpy(),
                "dot_basis": dp.dot_basis(X.T, Y[:, 0]).cpu().numpy(),
                "project": whole(dp, dp.project(X)),
            }
            if kernel == "union" and dp.Ub is not None and dp.H <= dp.L:
                *Ys, Xh = halo.union_interior_overlap(
                    dp.Ui, X, D, dp.Hb, "ab", dp.link)
                r["overlap"] = np.stack([whole(dp, Z) for Z in Ys])
                r["overlap_halo"] = whole(dp, Xh)
            res[m] = r
        dp.close()
        out[(kernel, impl, dtype)] = res
    return out


def solve_checks(spec, D, procs, device, kernel, halo_impl, dtype, runs,
                 traced=()):
    """Each run {label: (solver, kwargs)} on the pencil (solver
    "lobpcg_dist", "lanczos_dist" or "thick_restart_lanczos_dist"), its launch counts zeroed just before and read just after on
    every rank; the runs named in `traced` under torch.profiler (device
    activity only). {label:
    {"eigenvalues", "eigenvectors" (the problem's order), "residuals",
    "iterations", "history", "converged", "seconds", "counts", "wait_s",
    "exchanges" (the last three lists over the ranks: launches, host
    seconds in the exchanges' barriers, exchanges) and, traced,
    "device_busy_ms" (a list over the ranks)}}."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from maxwell_tpu_torch.utils import profiling

    from maxwell_tpu_torch.solvers import dist_solve, trlanczos

    fns = {"lobpcg_dist": dist_solve.lobpcg_dist,
           "lanczos_dist": dist_solve.lanczos_dist,
           "thick_restart_lanczos_dist": trlanczos.thick_restart_lanczos_dist}
    mesh, dp = pencil(spec, D, procs, device, kernel, halo_impl, dtype)
    out = {}
    link = dp.link
    for label, (solver, kwargs) in runs.items():
        _reset_counts()
        w0, e0 = (link.wait_s, link.exchanges) if link else (0.0, 0)
        if dp.device.type == "cuda":
            torch.cuda.synchronize(dp.device)
        # device activity only: a solve's host ops would make the trace's
        # summary cost more host time than the solve
        trace = (profile(activities=[ProfilerActivity.CUDA])
                 if label in traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with trace as prof:
            res = fns[solver](dp, mesh, **kwargs)
            if dp.device.type == "cuda":
                torch.cuda.synchronize(dp.device)
        seconds = time.perf_counter() - t0
        mine = {"counts": _kernel_counts(),
                "wait_s": link.wait_s - w0 if link else 0.0,
                "exchanges": link.exchanges - e0 if link else 0}
        if label in traced:
            mine["device_busy_ms"] = profiling.device_busy_ms(prof)
        every = [mine] if link is None else link.group.all_gather_object(
            mine)
        out[label] = {
            "eigenvalues": np.asarray(res.eigenvalues),
            "eigenvectors": np.asarray(res.eigenvectors),
            "residuals": np.asarray(res.residuals),
            "iterations": res.iterations, "converged": res.converged,
            "history": [h["max_rel_res"] for h in res.history or []],
            "seconds": seconds,
            **{k: [e[k] for e in every] for k in mine},
        }
    dp.close()
    return out


def exchange_bench(spec, D, procs, widths=(9, 1), seed=0, reps=20):
    """On the card: the exchanges across `procs` ranks of the union pencil
    ("rdma_overlap": K5 with both streams) and the blocked-ELL pencil
    ("rdma": K6 into the halo-extended buffer, and without own rows). Each
    kernel against the plain transport (a peer copy_) and K5's products
    against K2, bit for bit on every rank; the gathered halos and products
    for the caller to hold to one process; and per exchange (rank 0's) the
    host time of a whole exchange, the fences included, and of the plain
    transport, the kernel's device time (torch.profiler: under time-sliced
    contexts its span on the card), the host time a rank waits in the
    barriers, and the bytes the rank's launch reads (X) and writes.
    {"rows": [...], "outputs": {(name, m): array}, "seconds": the task's
    host time}."""
    from maxwell_tpu_torch.dist import make_mesh, partition_problem
    from maxwell_tpu_torch.kernels import halo, spmm
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem
    from maxwell_tpu_torch.utils import profiling

    def agree(name, m, ok):
        oks = [ok] if link is None else link.group.all_gather_object(ok)
        if not all(oks):
            raise AssertionError(f"{name} m={m}: not bit for bit on ranks "
                                 f"{oks}")

    def timed(fn):
        w0, e0 = (link.wait_s, link.exchanges) if link else (0.0, 0)
        torch.cuda.synchronize()
        t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t0) * 1e3)
        wait = ((link.wait_s - w0) * 1e3 / max(link.exchanges - e0, 1)
                if link else 0.0)
        return float(np.median(t)), wait

    t0 = time.perf_counter()
    problem = PermutedProblem(build_problem(spec))
    mesh = make_mesh(D, "cuda", procs)
    rows, outputs = [], {}
    for kernel, impl in (("union", "rdma_overlap"), ("pallas", "rdma")):
        dp = partition_problem(problem, D, kernel=kernel, reorder=False,
                               dtype=torch.float32, halo_impl=impl,
                               mesh=mesh)
        link, Hb = dp.link, dp.Hb
        for m in widths:
            X = block(dp, m, seed + m)
            if kernel == "union":
                *Ys, _ = halo.union_interior_overlap(dp.Ui, X, D, Hb, "ab",
                                                     link)
                k2 = [spmm.bellunion_matmat(dp.Ui, X, s) for s in "ab"]
                agree("K5 products vs K2", m,
                      all(bool(torch.equal(a, b)) for a, b in zip(Ys, k2)))
                outputs[("union_interior_overlap_Y", m)] = np.stack(
                    [whole(dp, Y) for Y in Ys])
                kinds = {"union_interior_overlap": (
                    lambda: halo.union_interior_overlap(
                        dp.Ui, X, D, Hb, "ab", link)[-1],
                    lambda: halo.ppermute(X, D, Hb, link=link), False)}
            else:
                kinds = {f"ring_shift_own{int(own)}": (
                    lambda own=own, pad=pad: halo.ring_shift(
                        X, D, Hb, own, pad, link),
                    lambda own=own, pad=pad: halo.ppermute(
                        X, D, Hb, own, pad, link), own)
                    for own, pad in ((True, dp.b), (False, 0))}
            for name, (kern, plain, own) in kinds.items():
                got = kern().clone()
                agree(f"{name} vs the plain transport", m,
                      bool(torch.equal(got, plain())))
                outputs[(name, m)] = whole(dp, got)
                ms, wait_ms = timed(kern)
                plain_ms, plain_wait_ms = timed(plain)
                with profiling.trace(None) as prof:
                    for _ in range(reps):
                        kern()
                tag = ("ring_shift_kernel" if kernel == "pallas"
                       else "union_overlap_kernel")
                dev = [k for k in profiling.top_kernels(prof, None)
                       if tag in k["name"]]
                rows.append({
                    "kernel": name, "m": m, "procs": procs, "own": own,
                    "rows_out": got.shape[0],
                    "local_rows": X.shape[0], "bitwise_equal_plain": True,
                    "exchange_ms": ms, "plain_exchange_ms": plain_ms,
                    "kernel_device_ms": (
                        sum(k["device_ms"] for k in dev)
                        / max(sum(k["launches"] for k in dev), 1)),
                    "barrier_wait_ms_per_exchange": wait_ms,
                    "plain_barrier_wait_ms_per_exchange": plain_wait_ms,
                    "bytes_read_x": X.numel() * 4,
                    "bytes_written": got.numel() * 4})
        dp.close()
    return {"rows": rows, "outputs": outputs,
            "seconds": time.perf_counter() - t0}


def cli(argv):
    """The CLI's run (cli/run.py) on this rank: (history lines, report)."""
    from maxwell_tpu_torch.cli import run

    return run.run(argv)


def sequence(calls):
    """[fn(*args) for fn, args in calls]: several tasks in one spawn."""
    return [fn(*args) for fn, args in calls]


def raise_on(rank: int, message: str) -> None:
    """The failure drill: ValueError(message) on rank `rank`, while the
    other ranks wait for it at a barrier."""
    from maxwell_tpu_torch.dist.procs import current

    group = current()
    if group.rank == rank:
        raise ValueError(message)
    group.barrier()
