"""What the ranks of a spawn run (dist/procs.py): the row-sharded pencil's
exchanges, applies, reductions and solves on P processes, each result
gathered to the whole problem, so a caller can hold P processes to one.

Each task is called as `spawn(task, P, ...)`, or directly in one process
with procs=1; both return the same structure (rank 0's, which every rank
holds), of host arrays. The tasks live in the package because a spawned
rank imports the module of its target function, which must import no more
than the port.

    apply_checks(spec, D, procs, device, cases, widths, seed)
    link_checks(spec, D, procs, device, cases, m, seed)
    padding_rank_overlap(spec, D, procs, device, widths, seed)
    solve_checks(spec, D, procs, device, kernel, halo_impl, dtype, runs)
    exchange_bench(spec, D, procs, widths, seed, reps)   (the card)
    slab_checks(dims, D, procs, device, cases, widths, seed)
    slab_solve(dims, D, procs, device, lobpcg_kwargs, refine_tol)
    slab_solves(dims, D, procs, device, dtype, runs)
    slab_bench(grid, D, procs, widths, seed, reps)       (the card)
    checkpoint_run(of, D, procs, device, path, lobpcg_kwargs)
    cli(argv)                                            (cli/run.py)
    sequence(calls)                                      several in one spawn
    places()                                             every rank's place
    raise_on(rank, message)                              the failure drill

The solve tasks take the distributed solvers by name: "lobpcg_dist",
"lanczos_dist", "shift_invert_lanczos_dist" and
"thick_restart_lanczos_dist" (mode="shift_invert" in its kwargs for the
MINRES apply).
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


def pencil(spec, D, procs, device, kernel, halo_impl, dtype, block=None):
    """(mesh, the row-sharded pencil of `spec` on it): this rank's shards
    (block: partition_problem's, None for the kernel's default)."""
    from maxwell_tpu_torch.dist import make_mesh, partition_problem

    mesh = make_mesh(D, device, procs)
    dp = partition_problem(build_problem(spec), D, block=block,
                           kernel=kernel, dtype=DTYPES[dtype],
                           halo_impl=halo_impl, mesh=mesh)
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


def _count_modules():
    from maxwell_tpu_torch.kernels import bsr_spmm, halo, spmm, stencil_taps

    return (spmm, bsr_spmm, halo, stencil_taps)


def kernel_counts() -> dict:
    """This process's launch counts of the distributed roads' kernels and
    the call counts of their plain versions."""
    return {k: v for mod in _count_modules()
            for k, v in mod.counts().items()}


def reset_counts() -> None:
    for mod in _count_modules():
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


def link_checks(spec, D, procs, device, cases, m=3, seed=0):
    """Each rank's link on the pencil of `spec` for each case (kernel,
    halo_impl, dtype): its mesh's topology report, the pencil's dcn_links,
    its sides' routes and which cross hosts, and what one exchange
    ([own | left | right | pad] and [left | right]) and one K apply moved:
    the change of each link counter (comm_model.link_volumes) over each.
    {(kernel, halo_impl, dtype): [per rank]}."""
    from maxwell_tpu_torch.bench.comm_model import link_volumes
    from maxwell_tpu_torch.dist import mesh_topology_report

    out = {}
    for kernel, impl, dtype in cases:
        mesh, dp = pencil(spec, D, procs, device, kernel, impl, dtype)
        X = block(dp, m, seed + m)
        link = dp.link
        moved = {}
        for name, fn in (("exchange_own", lambda: dp.exchange_halos(X)),
                         ("exchange_lr", lambda: dp._exchange(X, False, 0)),
                         ("K", lambda: dp.K_mm(X))):
            v0 = link_volumes(link)
            fn()
            v1 = link_volumes(link)
            moved[name] = {k: v1[k] - v0[k] for k in v1
                           if not k.endswith("_s")}
        mine = {"rank": mesh.rank, "report": mesh_topology_report(mesh),
                "dcn_links": list(dp.dcn_links),
                "routes": link.routes if link else None,
                "crosses": dict(link.crosses) if link else None,
                "moved": moved}
        out[(kernel, impl, dtype)] = _every(dp, mine)
        dp.close()
    return out


def padding_rank_overlap(spec, D, procs, device, widths=(9, 1), seed=0):
    """K5 (union_interior_overlap, both streams) against its plain version
    on every rank of the f32 union pencil of `spec` with "rdma_overlap",
    ranks that hold only padding rows included (on the card such a rank
    once left its second stream unwritten). Per width m and rank:
    {"padding_only", "err_a", "err_b" (max |kernel - plain| of each
    stream's product), "scale" (max |plain| of either), "halo_equal" (the
    halo section bit for bit the plain transport's)}, and the kernel's
    outputs gathered for the caller to hold to one process. {"n", "Lb",
    "ranks": {m: [per rank]}, "outputs": {m: (Ya, Yb, halo) whole}}."""
    from maxwell_tpu_torch.kernels import halo

    _, dp = pencil(spec, D, procs, device, "union", "rdma_overlap", "f32")
    ranks, outputs = {}, {}
    for m in widths:
        X = block(dp, m, seed + m)
        got = [T.clone() for T in halo.union_interior_overlap(
            dp.Ui, X, D, dp.Hb, "ab", dp.link)]
        want = halo.union_interior_overlap_ref(dp.Ui, X, D, dp.Hb, "ab",
                                               dp.link)
        mine = {"padding_only": dp.d0 * dp.Lb >= dp.n,
                "err_a": float((got[0] - want[0]).abs().max()),
                "err_b": float((got[1] - want[1]).abs().max()),
                "scale": float(max(want[0].abs().max(),
                                   want[1].abs().max())),
                "halo_equal": bool(torch.equal(got[2], want[2]))}
        ranks[m] = _every(dp, mine)
        outputs[m] = tuple(whole(dp, T) for T in got)
    dp.close()
    return {"n": dp.n, "Lb": dp.Lb, "ranks": ranks, "outputs": outputs}


def _solvers() -> dict:
    from maxwell_tpu_torch.solvers import dist_solve, trlanczos

    return {"lobpcg_dist": dist_solve.lobpcg_dist,
            "lanczos_dist": dist_solve.lanczos_dist,
            "shift_invert_lanczos_dist": dist_solve.shift_invert_lanczos_dist,
            "thick_restart_lanczos_dist":
                trlanczos.thick_restart_lanczos_dist}


_LINK_COUNTERS = ("wait_s", "exchanges", "gathers", "gather_s")


def _link_counters(link) -> dict:
    return {k: getattr(link, k) if link else 0 for k in _LINK_COUNTERS}


def _run_solves(mesh, dp, runs, traced=()):
    """Each run {label: (solver, kwargs)} on the distributed pencil dp, its
    launch counts zeroed just before and read just after on every rank;
    the runs named in `traced` under torch.profiler (device activity
    only). {label: {"eigenvalues", "eigenvectors" (the problem's order),
    "residuals", "iterations", "history", "converged", "tridiagonal"
    (Lanczos's (alphas, betas), else None), "seconds", "counts",
    "wait_s", "exchanges", "gathers", "gather_s" (lists over the ranks:
    launches, host seconds in the exchanges' barriers, exchanges, the
    reductions' gathers and their host seconds) and, traced,
    "device_busy_ms" (a list over the ranks)}}."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from maxwell_tpu_torch.utils import profiling

    fns = _solvers()
    out = {}
    link = dp.link
    for label, (solver, kwargs) in runs.items():
        reset_counts()
        c0 = _link_counters(link)
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
        c1 = _link_counters(link)
        mine = {"counts": kernel_counts(),
                **{k: c1[k] - c0[k] for k in _LINK_COUNTERS}}
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
            "tridiagonal": res.tridiagonal,
            "seconds": seconds,
            **{k: [e[k] for e in every] for k in mine},
        }
    return out


def solve_checks(spec, D, procs, device, kernel, halo_impl, dtype, runs,
                 traced=(), block=None):
    """The runs {label: (solver, kwargs)} of `_run_solves` on the
    row-sharded pencil of `spec` (block: partition_problem's)."""
    mesh, dp = pencil(spec, D, procs, device, kernel, halo_impl, dtype,
                      block)
    out = _run_solves(mesh, dp, runs, traced)
    dp.close()
    return out


def _timed(link, fn, reps) -> dict:
    """fn() over `reps` synchronized calls, each timed on the host and
    split by the link's counters: the medians of the whole call (`ms`),
    of its barrier wait (`wait_ms`), of its host-staged transfers
    (`host_staged_ms`: post and land) and of the rest (`ipc_side_ms`: the
    launch with its IPC pushes, the local copies, the stream syncs), each
    split 0 without a link; with a link also the routes of its sides and
    the bytes an exchange pushed on the host and sent across hosts."""
    from maxwell_tpu_torch.bench.comm_model import link_volumes

    torch.cuda.synchronize()
    calls, v0 = [], link_volumes(link)
    for _ in range(reps):
        a = link_volumes(link)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        b = link_volumes(link)
        wait, staged = b["wait_s"] - a["wait_s"], b["host_s"] - a["host_s"]
        calls.append((t, wait, staged, t - staged - wait))
    out = dict(zip(("ms", "wait_ms", "host_staged_ms", "ipc_side_ms"),
                   (float(np.median(c)) * 1e3 for c in zip(*calls))))
    if link is not None:
        v1 = link_volumes(link)
        n = max(v1["exchanges"] - v0["exchanges"], 1)
        out.update(routes=link.routes,
                   bytes_pushed=(v1["bytes_pushed"] - v0["bytes_pushed"]) // n,
                   bytes_across_hosts=(v1["bytes_across_hosts"]
                                       - v0["bytes_across_hosts"]) // n)
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
    barriers, and the bytes the rank's launch reads (X) and writes; and
    per rank (`sides`, a list over the ranks) the kernel exchange's timing
    (_timed: whole, host-staged, barrier wait and the rest, with the
    routes and the bytes pushed on the host and sent across hosts across
    processes) and that rank's `kernel_device_ms`. {"rows": [...],
    "outputs": {(name, m): array}, "counts": each rank's launches in the
    task, "seconds": the task's host time}."""
    from maxwell_tpu_torch.dist import make_mesh, partition_problem
    from maxwell_tpu_torch.kernels import halo, spmm
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem
    from maxwell_tpu_torch.utils import profiling

    def agree(name, m, ok):
        oks = [ok] if link is None else link.group.all_gather_object(ok)
        if not all(oks):
            raise AssertionError(f"{name} m={m}: not bit for bit on ranks "
                                 f"{oks}")

    t0 = time.perf_counter()
    reset_counts()
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
                sides = _timed(link, kern, reps)
                plain_t = _timed(link, plain, reps)
                with profiling.trace(None) as prof:
                    for _ in range(reps):
                        kern()
                tag = ("ring_shift_kernel" if kernel == "pallas"
                       else "union_overlap_kernel")
                dev = [k for k in profiling.top_kernels(prof, None)
                       if tag in k["name"]]
                sides["kernel_device_ms"] = (
                    sum(k["device_ms"] for k in dev)
                    / max(sum(k["launches"] for k in dev), 1))
                rows.append({
                    "kernel": name, "m": m, "procs": procs, "own": own,
                    "rows_out": got.shape[0],
                    "local_rows": X.shape[0], "bitwise_equal_plain": True,
                    "exchange_ms": sides["ms"],
                    "plain_exchange_ms": plain_t["ms"],
                    "kernel_device_ms": sides["kernel_device_ms"],
                    "barrier_wait_ms_per_exchange": sides["wait_ms"],
                    "plain_barrier_wait_ms_per_exchange": plain_t["wait_ms"],
                    "bytes_read_x": X.numel() * 4,
                    "bytes_written": got.numel() * 4,
                    "sides": _every(dp, sides)})
        dp.close()
    return {"rows": rows, "outputs": outputs,
            "counts": _every(dp, kernel_counts()),
            "seconds": time.perf_counter() - t0}


def cli(argv):
    """The CLI's run (cli/run.py) on this rank: (history lines, report)."""
    from maxwell_tpu_torch.cli import run

    return run.run(argv)


def sequence(calls):
    """[fn(*args) for fn, args in calls]: several tasks in one spawn."""
    return [fn(*args) for fn, args in calls]


def places() -> list:
    """Every rank's place, in rank order: {"rank", "procs", "host",
    "hosts", "host_ranks", "device", "pid"}."""
    import os

    from maxwell_tpu_torch.dist.procs import current

    g = current()
    return g.all_gather_object({
        "rank": g.rank, "procs": g.procs, "host": g.host, "hosts": g.hosts,
        "host_ranks": list(g.host_ranks), "device": str(g.device),
        "pid": os.getpid()})


def raise_on(rank: int, message: str) -> None:
    """The failure drill: ValueError(message) on rank `rank`, while the
    other ranks wait for it at a barrier."""
    from maxwell_tpu_torch.dist.procs import current

    group = current()
    if group.rank == rank:
        raise ValueError(message)
    group.barrier()


# --- the slab-sharded pencil (dist/stencil_dist.py) --------------------------


def slab_pencil(dims, D, procs, device, dtype="f64", materials=None):
    """(mesh, this rank's DistStencilPencil3D) of the brick `dims` (a dict
    of build's a, b, c_len, nx, ny, nz) in D slabs; materials: (eps_r,
    mu_r) numpy grids, or None for vacuum."""
    from maxwell_tpu_torch.dist import make_mesh
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D

    eps_r, mu_r = materials if materials is not None else (None, None)
    mesh = make_mesh(D, device, procs)
    sp = DistStencilPencil3D.build(**dims, D=D, dtype=DTYPES[dtype],
                                   eps_r=eps_r, mu_r=mu_r, mesh=mesh)
    return mesh, sp


def slab_whole(sp, T: torch.Tensor) -> np.ndarray:
    """Every rank's rows of T (the slab pencil's stacked layout), stacked,
    on the host: not counted in the link's gathers."""
    T = T.detach()
    if sp.link is not None:
        T = sp.link.group.all_gather(T).reshape(-1, *T.shape[1:])
    return T.cpu().numpy()


def slab_block(sp, m: int, seed: int) -> torch.Tensor:
    """This rank's rows of a global (n_full, m) normal block drawn with
    numpy from `seed`, injected into the stacked layout (interface copies
    agree, padding zero)."""
    rng = np.random.default_rng(seed)
    return sp.inject_vectors(rng.standard_normal((sp.n_full, m)))


def _every(sp, value):
    return [value] if sp.link is None else sp.link.group.all_gather_object(
        value)


def slab_checks(dims, D, procs, device, cases, widths=(1, 3), seed=0):
    """For each case (dtype, materials) and width m, on blocks drawn from
    `seed`: the ghost-extended blocks, the K, M and fused applies, the
    projection, the reductions (dot_mm, dot_cols, col_norms, dot_vv,
    dot_basis); on a vacuum pencil also the double-word apply (both words
    of both operators) and the spectral solves (solve at alpha 6,
    solve_sigma at per-column shifts). Each rank's link counters, lists
    over the ranks: around one fused apply "push_bytes_KM" (bytes sent to
    the neighbours on the rank's host), "across_bytes_KM" (to those on
    another host) and "gathers_KM"; the bytes gathered by one projection
    ("gather_bytes_project") and, vacuum, one spectral solve
    ("gather_bytes_solve"). {case index: {m: {name: array}}}."""
    from maxwell_tpu_torch.solvers.spectral import DistSpectralShift
    from maxwell_tpu_torch.utils import twofloat as tf

    out = {}
    for i, (dtype, materials) in enumerate(cases):
        _, sp = slab_pencil(dims, D, procs, device, dtype, materials)
        res = {}
        for m in widths:
            X, Y = slab_block(sp, m, seed + m), slab_block(sp, m,
                                                           seed + 100 + m)
            link = sp.link

            def gathered(fn):
                b0 = link.bytes_gathered if link else 0
                out = fn()
                return out, np.asarray(_every(
                    sp, (link.bytes_gathered - b0) if link else 0))

            p0 = link.bytes_pushed if link else 0
            a0 = link.bytes_across_hosts if link else 0
            g0 = link.gathers if link else 0
            KM = sp.KM_mm(X)
            r = {"KM": np.stack([slab_whole(sp, Z) for Z in KM]),
                 "push_bytes_KM": np.asarray(_every(
                     sp, (link.bytes_pushed - p0) if link else 0)),
                 "across_bytes_KM": np.asarray(_every(
                     sp, (link.bytes_across_hosts - a0) if link else 0)),
                 "gathers_KM": np.asarray(_every(
                     sp, (link.gathers - g0) if link else 0)),
                 "ext": slab_whole(sp, sp._ext_block(X).reshape(-1, m)),
                 "K": slab_whole(sp, sp.K_mm(X)),
                 "M": slab_whole(sp, sp.M_mm(X)),
                 "project": slab_whole(sp, sp.project(X)),
                 "gather_bytes_project": gathered(lambda: sp.project(X))[1],
                 "dot_mm": sp.dot_mm(X, Y).cpu().numpy(),
                 "dot_cols": sp.dot_cols(X, Y).cpu().numpy(),
                 "col_norms": sp.col_norms(X).cpu().numpy(),
                 "dot_vv": sp.dot_vv(X[:, 0], Y[:, 0]).cpu().numpy(),
                 "dot_basis": sp.dot_basis(X.T, Y[:, 0]).cpu().numpy()}
            if materials is None:
                X64 = slab_block(sp, m, seed + 200 + m).double().cpu()
                Xh, Xl = (torch.from_numpy(w).to(sp.device)
                          for w in tf.dw_from_f64(X64.numpy()))
                (Kh, Kl), (Mh, Ml) = sp.KM_mm_dw(Xh, Xl)
                r["KM_dw"] = np.stack([slab_whole(sp, Z)
                                       for Z in (Kh, Kl, Mh, Ml)])
                sol = DistSpectralShift.build(sp, 6.0)
                W, r["gather_bytes_solve"] = gathered(
                    lambda: sol.solve(sp, X))
                r["solve"] = slab_whole(sp, W)
                sigma = torch.linspace(3.0, 40.0, m, dtype=sp.dtype,
                                       device=sp.device)
                r["solve_sigma"] = slab_whole(sp, DistSpectralShift.build(
                    sp, 0.0).solve_sigma(sp, X, sigma))
            res[m] = r
        sp.close()
        out[i] = res
    return out


def slab_solve(dims, D, procs, device, lobpcg_kwargs, refine_tol=1e-8,
               dtype="f32", X0=None):
    """lobpcg_dist on the vacuum slab pencil from X0 (a host (n_full, m)
    block in the global stencil ordering, carried to each rank's rows by
    inject_vectors; None: the pencil's make_block), then refine_dw_dist of
    its block to refine_tol on every rank; counts zeroed just before, read
    just after. {"eigenvalues", "eigenvectors" (the global ordering),
    "residuals", "iterations", "history" (the solve's),
    "refined_eigenvalues", "refined_residuals",
    "refined_eigenvectors" (the global ordering), "refine_iterations",
    "counts" (a list over the ranks), "seconds"}."""
    from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist
    from maxwell_tpu_torch.solvers.refine_device import refine_dw_dist

    mesh, sp = slab_pencil(dims, D, procs, device, dtype)
    if X0 is not None:
        lobpcg_kwargs = {**lobpcg_kwargs, "X0": sp.inject_vectors(X0)}
    reset_counts()
    t0 = time.perf_counter()
    res = lobpcg_dist(sp, mesh, **lobpcg_kwargs)
    ref = refine_dw_dist(sp, mesh, res.eigenvectors, tol=refine_tol)
    seconds = time.perf_counter() - t0
    counts = _every(sp, kernel_counts())
    sp.close()
    return {"eigenvalues": np.asarray(res.eigenvalues),
            "eigenvectors": np.asarray(res.eigenvectors),
            "residuals": np.asarray(res.residuals),
            "iterations": res.iterations,
            "history": [h["max_rel_res"] for h in res.history],
            "refined_eigenvalues": np.asarray(ref.eigenvalues),
            "refined_residuals": np.asarray(ref.residuals),
            "refined_eigenvectors": np.asarray(ref.eigenvectors),
            "refine_iterations": ref.iterations, "converged": ref.converged,
            "counts": counts, "seconds": seconds}


def slab_solves(dims, D, procs, device, dtype, runs, traced=()):
    """The runs {label: (solver, kwargs)} of `_run_solves` on the vacuum
    slab pencil of the brick `dims` in D slabs."""
    mesh, sp = slab_pencil(dims, D, procs, device, dtype)
    out = _run_solves(mesh, sp, runs, traced)
    sp.close()
    return out


# --- checkpoints -------------------------------------------------------------


def _make_pencil(of, D, procs, device):
    """(mesh, pencil) of `of`: ("rows", spec, kernel, halo_impl, dtype) or
    ("slabs", dims, dtype)."""
    if of[0] == "rows":
        return pencil(of[1], D, procs, device, *of[2:])
    if of[0] == "slabs":
        return slab_pencil(of[1], D, procs, device, of[2])
    raise ValueError(f"unknown pencil {of!r}")


def checkpoint_run(of, D, procs, device, path, lobpcg_kwargs):
    """lobpcg_dist(checkpoint=path, **lobpcg_kwargs) on the pencil `of`
    (see _make_pencil; an X0 in the kwargs is a host block in the stacked
    layout, else the run resumes from the checkpoint where one is there).
    {"eigenvalues", "residuals", "iterations", "history" (the (iteration,
    residual) pairs), "converged", "eigenvectors" (the problem's
    ordering)}."""
    from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist

    mesh, dp = _make_pencil(of, D, procs, device)
    res = lobpcg_dist(dp, mesh, checkpoint=path, **lobpcg_kwargs)
    dp.close()
    return {"eigenvalues": np.asarray(res.eigenvalues),
            "residuals": np.asarray(res.residuals),
            "iterations": res.iterations, "converged": res.converged,
            "history": [(h["iter"], h["max_rel_res"]) for h in res.history],
            "eigenvectors": np.asarray(res.eigenvectors)}


def slab_bench(grid, D, procs, widths=(9, 1), seed=0, reps=20):
    """On the card: the grid^3 f32 brick in D slabs over `procs` ranks.
    Per width m, on a block random on every row (numpy, seed + m): the
    ghost exchange (each rank's extended block, its neighbours' edge
    planes pushed into it) and the tap kernel K4 on each of the rank's
    extended blocks (fused K/M), within 1e-5 of max|plain| of the plain
    slab apply on every rank; the gathered blocks and outputs for the
    caller to hold to one process; and per rank: K4's device time a fused
    apply (torch.profiler: under time-sliced contexts its span on the
    card), the host time of a whole exchange (fences included), of a
    whole K4 apply and of the plain apply, the barrier wait a exchange,
    K4's launches a apply, the bytes and operations of the rank's apply
    for its bound, and the ghost exchange's timing (`sides`, _timed).
    {"rows": [...]
    (rank 0's, with the per-rank lists), "outputs": {(name, m): array},
    "seconds"}."""
    from maxwell_tpu_torch.kernels import stencil_taps as kst
    from maxwell_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    _, sp = slab_pencil(dict(nx=grid, ny=grid, nz=grid), D, procs, "cuda",
                        "f32")
    link = sp.link

    rows, outputs = [], {}
    taps_per_row = float(np.mean([len(t) for t in sp.taps]))
    live = float(sp.mask.sum())
    for m in widths:
        Xg = np.random.default_rng(seed + m).standard_normal(
            (sp.global_rows, m)).astype(np.float32)
        X = sp.local(torch.from_numpy(Xg)).to(sp.device)
        outputs[("ext", m)] = slab_whole(
            sp, sp._ext_block(X).reshape(-1, m).clone())
        kst.reset_counts()
        got = sp._taps_apply_ext(X, True, True)
        torch.cuda.synchronize()
        launches = kst.counts()["stencil_taps"]
        want = sp._taps_apply_plain(X, True, True)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        scale = max(b.abs().max().item() for b in want)
        outputs[("KM", m)] = np.stack([slab_whole(sp, Y) for Y in got])
        sides = _timed(link, lambda: sp._ext_block(X), reps)
        apply_t = _timed(link, lambda: sp._taps_apply_ext(X, True, True),
                         reps)
        plain_t = _timed(link, lambda: sp._taps_apply_plain(X, True, True),
                         reps)
        with profiling.trace(None) as prof:
            for _ in range(reps):
                sp._taps_apply_ext(X, True, True)
        dev = [k for k in profiling.top_kernels(prof, None)
               if "stencil_taps" in k["name"]]
        rows_local = sp.n_padded
        mine = {"max_abs_err": err, "rel_err": err / scale,
                "within_tol": err <= 1e-5 * scale,
                "kernel_device_ms_per_apply":
                    sum(k["device_ms"] for k in dev) / reps,
                "launches_per_apply": launches,
                "exchange_ms": sides["ms"],
                "barrier_wait_ms_per_exchange": sides["wait_ms"],
                "apply_ms": apply_t["ms"],
                "apply_barrier_wait_ms": apply_t["wait_ms"],
                "plain_ms": plain_t["ms"],
                "bytes": rows_local * m * 4 * 3 + rows_local * 4,
                "flops": 2 * live * taps_per_row * 2 * m,
                "sides": sides}
        every = _every(sp, mine)
        if not all(e["within_tol"] for e in every):
            raise AssertionError(f"K4 on the slabs m={m}: "
                                 f"{[e['rel_err'] for e in every]}")
        rows.append({"m": m, "procs": procs, "grid": grid, "slabs": D,
                     "local_rows": rows_local, **mine,
                     **{f"{k}_per_rank": [e[k] for e in every]
                        for k in mine}})
    sp.close()
    return {"rows": rows, "outputs": outputs,
            "seconds": time.perf_counter() - t0}
