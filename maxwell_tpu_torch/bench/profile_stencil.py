"""Where the time of the 64^3 matrix-free path goes on the card: 10 f32
LOBPCG iterations (spectral preconditioner) after a warm-up, then one
`refine_dw`, each timed on the host clock and traced with torch.profiler
(device time by kernel, top rows printed, and the tap kernel's total).
With --slabs D the same on the slab-sharded pencil in D slabs:
lobpcg_dist with DistSpectralShift, then refine_dw_dist.

    python -m maxwell_tpu_torch.bench.profile_stencil [--slabs 8]

Needs a CUDA device.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
from maxwell_tpu_torch.solvers.lobpcg import lobpcg
from maxwell_tpu_torch.solvers.refine_device import refine_dw
from maxwell_tpu_torch.solvers.spectral import spectral_preconditioner

GRID = 64  # the reference bench's time-to-1e-8 row, n = 811,200


def timed(label, fn, rows):
    """Run fn once unprofiled (host clock) and once under the profiler."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    launches = sum(e.count for e in ka
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{label}: wall {wall * 1e3:.1f} ms unprofiled, device busy "
          f"{device_ms:.1f} ms in {launches} device ops "
          f"(idle {100 * max(0.0, 1 - device_ms / (wall * 1e3)):.0f}%)")
    print(ka.table(sort_by="self_cuda_time_total", row_limit=rows,
                   max_name_column_width=60))
    taps = [e for e in ka if "stencil_taps" in e.key
            and e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"{label}: stencil_taps "
          f"{sum(e.self_device_time_total for e in taps) / 1e3:.3f} ms in "
          f"{sum(e.count for e in taps)} launches")
    return out


def main_slabs(D: int):
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
    from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist
    from maxwell_tpu_torch.solvers.refine_device import refine_dw_dist

    p = DistStencilPencil3D.build(nx=GRID, ny=GRID, nz=GRID, D=D,
                                  dtype=torch.float32, device="cuda")
    kw = dict(nev=5, precond="spectral", precond_alpha=15.0)
    lobpcg_dist(p, None, maxiter=3, tol=1e-30, **kw)  # warm-up
    timed(f"lobpcg_dist ({D} slabs), 10 iterations",
          lambda: lobpcg_dist(p, None, maxiter=10, tol=1e-30, **kw), 15)
    r = lobpcg_dist(p, None, maxiter=60, tol=2e-6, stall_window=10, **kw)
    refine_dw_dist(p, None, r.eigenvectors, tol=1e-8)  # warm-up
    out = timed(f"refine_dw_dist ({D} slabs)",
                lambda: refine_dw_dist(p, None, r.eigenvectors, tol=1e-8),
                10)
    print(f"refine_dw_dist sweeps: {out.iterations - 1}, "
          f"max residual {out.residuals.max():.2e}")


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--slabs", type=int, default=1,
                    help="slab-sharded pencil in this many slabs (1: the "
                    "one-device pencil)")
    args = ap.parse_args()
    if args.slabs > 1:
        return main_slabs(args.slabs)
    p = StencilPencil3D.build(nx=GRID, ny=GRID, nz=GRID, dtype=torch.float32,
                              device="cuda")
    pc = spectral_preconditioner(p, alpha=15.0)
    lobpcg(p, nev=5, maxiter=3, tol=1e-30, precond=pc)  # warm-up
    timed("lobpcg, 10 iterations",
          lambda: lobpcg(p, nev=5, maxiter=10, tol=1e-30, precond=pc), 15)
    r = lobpcg(p, nev=5, maxiter=60, tol=2e-6, precond=pc, stall_window=10)
    refine_dw(p, r.eigenvectors, tol=1e-8)  # warm-up
    out = timed("refine_dw", lambda: refine_dw(p, r.eigenvectors, tol=1e-8),
                10)
    print(f"refine_dw sweeps: {out.iterations - 1}, "
          f"max residual {out.residuals.max():.2e}")


if __name__ == "__main__":
    main()
