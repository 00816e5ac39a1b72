"""Driver entry points of the port (the counterpart of __graft_entry__.py):
the flagship step on one device, and a dry run of every distributed
branch.

entry(device): (fn, (pencil, X0)) — one LOBPCG iteration (SpMM, SVQB,
Rayleigh-Ritz) on the 32x32 RectCavity2D pencil at f32, m 8: the union
CUDA kernels (K1, K2) on the card, the plain blocked-ELL apply on the CPU.

dryrun_multichip(n, device, procs=1): every branch of the reference's
distributed dry run on n row shards or slabs, on tiny shapes, returning its
checks (raising on the first that fails); the row-sharded and the slab
branches on `procs` processes (dist/procs.py).

    python -m maxwell_tpu_torch.entry [--shards 8] [--procs 1]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from maxwell_tpu_torch.utils.precision import fp32_true


@fp32_true
def step(pencil, X0):
    """One LOBPCG iteration from X0: (theta, residuals), (m,) each."""
    from maxwell_tpu_torch.solvers.lobpcg import lobpcg_run

    theta, X, res, it, hist = lobpcg_run(pencil, X0, 1, 1e-8, None, nev=4)
    return theta, res


def entry(device="cuda"):
    """Return (fn, example_args): the flagship step on `device` (the card
    unless the caller asks for the CPU). X0 is drawn on the CPU from seed 0
    and moved, so every device starts from the same block."""
    from maxwell_tpu_torch.problems import RectCavity2D
    from maxwell_tpu_torch.solvers.operator import Pencil

    dev = torch.device(device)
    kern = "union" if dev.type == "cuda" else "ref"
    pencil = Pencil.from_problem(RectCavity2D(nx=32, ny=32), block=8,
                                 kernel=kern, dtype=torch.float32, device=dev)
    m = 8
    X0 = torch.randn((pencil.n_padded, m),
                     generator=torch.Generator().manual_seed(0))
    X0[pencil.n:] = 0.0
    return step, (pencil, X0.to(dev))


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def dryrun_multichip(n_devices: int, device="cuda", procs: int = 1) -> dict:
    """One distributed LOBPCG step (and the other distributed solvers) on
    n_devices shards of `device`, through every branch of
    __graft_entry__.dryrun_multichip: the blocked-ELL pencil ("pallas":
    K8 SpMM, K10 SpMV) with slice halos, with the ring shift ("rdma", K6)
    and with the DCN-first schedule; the union pencil, plain and with the
    fused interior SpMM + halo copy ("rdma_overlap", K5); the staged
    `batch` solve; lanczos_dist; thick_restart_lanczos_dist (the
    assembled branches); then the slab pencil (K4 on its ghost-extended
    slabs); refine_dw_dist; the device-resident chain (lobpcg_dist ->
    refine_dw_dist with return_device); the staged solve with
    stage_polish (the slab branches). All of them on `procs` processes
    (dist/procs.py), D / procs shards or slabs each.

    Returns {check: True} for each step, and the max |difference| of the
    bit-for-bit comparisons (0.0, the largest over the ranks); raises on
    the first failure (AssertionError; across processes RankError with
    it)."""
    if procs > 1:
        from maxwell_tpu_torch.dist.procs import spawn

        return spawn(dryrun_branches, procs, n_devices, device, procs,
                     device=device)
    return dryrun_branches(n_devices, device)


def dryrun_branches(n_devices: int, device="cuda", procs: int = 1) -> dict:
    """Every branch of dryrun_multichip on this process's shards and slabs
    of meshes over `procs` processes (called in each rank of a spawn when
    procs > 1)."""
    checks = assembled_branches(n_devices, device, procs)
    checks.update(_slab_branches(n_devices, device, procs))
    return checks


def _checker(n_devices, group):
    checks = {}

    def check(name, ok, value=None):
        checks[name] = True if value is None else value
        if not ok:
            raise AssertionError(f"dryrun_multichip({n_devices}): {name} "
                                 f"failed ({value})")

    def same(name, a, b):
        diff = float((a - b).abs().max())
        if group is not None:
            diff = max(group.all_gather_object(diff))
        check(name, diff == 0.0, diff)

    return checks, check, same


def _nev_of(res, k):
    return res.eigenvalues.shape == (k,) and bool(
        np.all(np.isfinite(res.eigenvalues)))


def assembled_branches(n_devices: int, device="cuda", procs: int = 1
                       ) -> dict:
    """The row-sharded branches of dryrun_multichip on this process's
    shards of a mesh over `procs` processes (called in each rank of a
    spawn when procs > 1)."""
    from maxwell_tpu_torch.dist import (
        make_mesh,
        mesh_topology_report,
        partition_problem,
    )
    from maxwell_tpu_torch.dist.procs import current
    from maxwell_tpu_torch.problems import RectCavity2D
    from maxwell_tpu_torch.solvers.dist_solve import (
        lanczos_dist,
        lobpcg_dist,
        spmm_dist,
    )
    from maxwell_tpu_torch.solvers.trlanczos import thick_restart_lanczos_dist

    mesh = make_mesh(n_devices, torch.device(device), procs)
    dev = mesh.device
    f32 = torch.float32
    checks, check, same = _checker(n_devices, mesh.group)
    group = current()  # the spawn's group: the hosts its ranks span
    check("mesh_processes",
          mesh_topology_report(mesh)["real"] == {
              "devices": procs, "hosts": group.hosts if group else 1})

    # tiny shapes; grids chosen so each shard still has real halo traffic
    cav = RectCavity2D(nx=16, ny=16)
    lob = dict(nev=2, m=4, maxiter=2, tol=1e-30)
    dp = partition_problem(cav, n_devices, block=8, kernel="pallas",
                           dtype=f32, mesh=mesh)
    check("lobpcg_dist_pallas",
          _nev_of(lobpcg_dist(dp, mesh, precond_alpha=10.0, **lob), 2))
    check("lanczos_dist",
          _nev_of(lanczos_dist(dp, mesh, nev=2, maxiter=6, tol=1e-30), 2))

    dp_u = partition_problem(cav, n_devices, kernel="union", dtype=f32,
                             mesh=mesh)
    check("lobpcg_dist_union",
          _nev_of(lobpcg_dist(dp_u, mesh, precond_alpha=10.0, **lob), 2))

    # the ring-shift transport must give the slice transport's product bit
    # for bit, and its halo checksum against the gather oracle must be 0
    dp_rd = partition_problem(cav, n_devices, block=8, kernel="pallas",
                              dtype=f32, halo_impl="rdma", mesh=mesh)
    Xh = torch.randn((dp.global_rows, 2),
                     generator=torch.Generator().manual_seed(1)).to(dev)
    same("spmm_rdma_vs_ppermute", spmm_dist(dp_rd, mesh, Xh, which="K"),
         spmm_dist(dp, mesh, Xh, which="K"))
    err = float(dp_rd.halo_checksum(dp_rd.local(Xh)))
    if mesh.group is not None:
        err = max(mesh.group.all_gather_object(err))
    check("halo_checksum", err == 0.0, err)
    dp_rd.close()
    del dp_rd

    # the fused interior SpMM + halo copy against the union path, where
    # the reference checks it (halo no deeper than a shard)
    dp_ov = partition_problem(cav, n_devices, kernel="union", dtype=f32,
                              halo_impl="rdma_overlap", mesh=mesh)
    if dp_ov.H <= dp_ov.L:
        Xu = dp_u.make_block(2, torch.Generator().manual_seed(1))
        same("spmm_rdma_overlap_vs_union",
             spmm_dist(dp_ov, mesh, Xu, which="K"),
             spmm_dist(dp_u, mesh, Xu, which="K"))
    dp_ov.close()
    dp_u.close()
    del dp_ov, dp_u
    _free(dev)

    # the DCN-first halo schedule (a synthetic cross-host link)
    dp_dcn = partition_problem(
        cav, n_devices, block=8, kernel="pallas", dtype=f32,
        dcn_links=(n_devices // 2,) if n_devices > 1 else (), mesh=mesh)
    check("lobpcg_dist_dcn",
          _nev_of(lobpcg_dist(dp_dcn, mesh, precond_alpha=10.0, **lob), 2))
    dp_dcn.close()
    del dp_dcn

    check("lobpcg_dist_staged", _nev_of(lobpcg_dist(
        dp, mesh, nev=4, batch=2, maxiter=3, tol=1e-30,
        precond_alpha=10.0), 4))
    check("thick_restart_lanczos_dist", _nev_of(thick_restart_lanczos_dist(
        dp, mesh, nev=2, ncv=8, max_restarts=2, tol=1e-30), 2))
    dp.close()
    del dp
    _free(dev)
    return checks


def _slab_branches(n_devices: int, device, procs: int = 1) -> dict:
    """The slab-sharded branches of dryrun_multichip on this process's
    slabs of a mesh over `procs` processes."""
    from maxwell_tpu_torch.dist import make_mesh
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
    from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist
    from maxwell_tpu_torch.solvers.refine_device import refine_dw_dist

    mesh = make_mesh(n_devices, torch.device(device), procs)
    dev = mesh.device
    f32 = torch.float32
    checks, check, _ = _checker(n_devices, mesh.group)
    lob = dict(nev=2, m=4, maxiter=2, tol=1e-30)
    sp = DistStencilPencil3D.build(nx=2 * n_devices, ny=4, nz=3,
                                   D=n_devices, dtype=f32, mesh=mesh)
    check("lobpcg_dist_slab",
          _nev_of(lobpcg_dist(sp, mesh, precond_alpha=15.0, **lob), 2))
    sp.close()
    del sp

    sp2 = DistStencilPencil3D.build(nx=2 * n_devices, ny=4, nz=3,
                                    D=n_devices, dtype=f32, mesh=mesh)
    r0 = lobpcg_dist(sp2, mesh, nev=2, m=4, maxiter=3, tol=1e-30,
                     precond_alpha=15.0)
    ref = refine_dw_dist(sp2, mesh, r0.eigenvectors, tol=1e-8, max_sweeps=2)
    check("refine_dw_dist", ref.eigenvalues.shape[0] == 2)

    # the device-resident chain: the block stays on the device between the
    # stages, only (m,) results reach the host
    r5 = lobpcg_dist(sp2, mesh, nev=2, m=4, maxiter=3, tol=1e-30,
                     precond_alpha=15.0, return_device=True)
    X5 = r5.eigenvectors
    check("lobpcg_dist_return_device",
          torch.is_tensor(X5) and X5.device.type == dev.type
          and X5.shape == (sp2.n_padded, 2))
    ref5 = refine_dw_dist(sp2, mesh, X5, tol=1e-8, max_sweeps=2,
                          return_device=True)
    check("refine_dw_dist_return_device",
          isinstance(ref5.eigenvectors, tuple) and all(
              torch.is_tensor(v) and v.device.type == dev.type
              and v.shape == (sp2.n_padded, 2)
              for v in ref5.eigenvectors))

    rstaged = lobpcg_dist(
        sp2, mesh, nev=4, batch=2, maxiter=3, tol=1e-30, precond_alpha=15.0,
        stage_polish=lambda r: refine_dw_dist(
            sp2, mesh, r.eigenvectors, tol=1e-8, max_sweeps=2))
    check("stage_polish", rstaged.eigenvalues.shape == (4,))
    sp2.close()
    del sp2
    _free(dev)
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, (pencil, X0) = entry(args.device)
    theta, res = fn(pencil, X0)
    print(json.dumps({"entry_theta": theta.tolist(),
                      "entry_residuals": res.tolist()}))
    print(json.dumps({"dryrun": dryrun_multichip(args.shards, args.device,
                                                 args.procs)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
