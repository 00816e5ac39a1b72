"""Timing and bounds on the card, shared by the probes and chip_smoke.py:
the port's counterpart of maxwell_tpu/bench/exp_gather.py::timeit_chain.

    median_ms(fn)            median of n launches of fn, CUDA events
    copy_bandwidth(device)   bytes/s of one 256 MB elementwise read + write,
                             the denominator of every "% of own roofline"
    bound_ms(bytes, flops, kind)   the least time the card could take
    with_tf32(fn)            fn with TF32 allowed for its matmuls only: a
                             library call on f32 operands at the rate of
                             the probes' bf16 kernels
    csr_bytes(A, m)          bytes a CSR product with an (n, m) block moves
    union_bytes(A, s, m)     bytes a union kernel call reads and writes, on
                             the live form and on the full layout
    torch_csr(A, device)     a scipy matrix as a torch CSR tensor (f32), the
                             operand of the library call torch.sparse.mm

Every rate here is measured on, or published for, an NVIDIA H100 SXM: a CPU
device has no such number, and the timers raise there.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

LAUNCHES = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FLOPS_PER_S = {"f32": 67e12, "bf16": 989e12}  # H100 SXM dense peaks
COPY_BYTES = 256 * 2**20


def median_ms(fn, n: int = LAUNCHES) -> float:
    """Median of n launches, each timed by its own pair of CUDA events. A
    device-side sleep queued first keeps the card busy while the host
    enqueues the launches, so a kernel shorter than its host-side launch
    cost is timed on the device alone."""
    if not torch.cuda.is_available():
        raise RuntimeError("median_ms times on a CUDA device; none is visible")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clock
    pairs = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def copy_bandwidth(device="cuda", nbytes: int = COPY_BYTES) -> float:
    """Bytes per second of one elementwise pass over nbytes of f32 (read
    once, written once into a second buffer): the counterpart of
    maxwell_tpu/bench/exp_union2.py:55-57's jnp.abs(x) + 1.0."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"a device rate needs a CUDA device, not {device}")
    x = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    ms = median_ms(lambda: torch.add(x, 1.0, out=y))
    return 2 * nbytes / (ms * 1e-3)


def bound_ms(nbytes, flops, kind):
    """(ms, "bytes" | "operations"): bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def with_tf32(fn):
    """A call of fn() with torch.backends.cuda.matmul.allow_tf32 set for
    its duration, the caller's setting restored after."""

    def call():
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    return call


def csr_bytes(A, m: int) -> int:
    """Bytes a product of the CSR matrix A with an (n, m) f32 block must
    move: values and column indices (4 B each), row pointers, X read once
    and Y written once."""
    rows, cols = A.shape
    return A.nnz * 8 + (rows + 1) * 4 + cols * m * 4 + rows * m * 4


def union_bytes(A, streams, m):
    """(layout_bytes, fill_bytes) of a union kernel call on A at width m.
    layout_bytes: what the kernel reads and writes: the live sub-blocks'
    values (4 bytes each: f32, or bf16 hi + lo), the live X runs once (16
    rows of m f32 each; every block of a tile stages its chunks' runs, from
    L2), the live tables, ucols and tile_ptr, Y. fill_bytes: the same with
    the full value streams (the zero fill) and every lane's X row, what the
    kernels read before the live form."""
    L = A.live
    y = streams * A.n_padded * m * 4
    tables = (A.ucols.numel() + A.tile_ptr.numel()) * 4
    live = (streams * L.n_blocks * 128 * 4 + L.n_runs * 16 * m * 4 + tables
            + (L.sb_ptr.numel() + L.sb_run.numel() + L.xr_ptr.numel()
               + L.xr_run.numel()) * 4 + y)
    fill = streams * A.nnz_dense * 4 + tables + A.n_chunks * A.cl * m * 4 + y
    return live, fill


def torch_csr(A, device):
    A = A.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data.astype(np.float32)),
        size=A.shape, device=device,
    )
