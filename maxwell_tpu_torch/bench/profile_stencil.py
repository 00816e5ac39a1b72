"""Where the time of the 64^3 matrix-free path goes on the card: 10 f32
LOBPCG iterations (spectral preconditioner) after a warm-up, then one
`refine_dw`, each timed on the host clock and traced with torch.profiler
(device time by kernel, top rows printed, and the tap kernel's total).

    python -m maxwell_tpu_torch.bench.profile_stencil

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


def main():
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
