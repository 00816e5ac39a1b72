"""Timing and bounds on the card, shared by the probes and chip_smoke.py:
the port's counterpart of maxwell_tpu/bench/exp_gather.py::timeit_chain.

    median_ms(fn)            median of n launches of fn, CUDA events
    chain_ms(fn)             n back-to-back launches between one pair of
                             events, over n (median of 5 such chains)
    device_ms(fn)            median of n calls, each queued whole behind its
                             own device sleep: the device's time for a call
                             of many launches that the host enqueues slower
                             than the device runs them
    wall_ms(fn)              median host time of n calls, each between two
                             synchronizes: for a call that synchronizes on
                             its own (a sparse triangular solve, a Krylov
                             loop that reads its residual on the host)
    launch_floor_ms()        median_ms of an empty launch
    chain_floor_ms()         chain_ms of an empty launch
    copy_bandwidth(device)   bytes/s of one 256 MB elementwise read + write,
                             the denominator of every "% of own roofline"
    l2_read_rate(device)     bytes/s the SMs read from L2: every block
                             re-reads one 1.2 MB buffer
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
import time

import numpy as np
import torch

LAUNCHES = 20
CHAIN, CHAIN_RUNS = 200, 5  # launches a chain, chains a chain_ms
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock
CLOCK_HZ = 2.0e9  # above the H100's boost clock (1.98 GHz): cycles -> s
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM dense peaks (NVIDIA's data sheet); f64 outside the tensor cores
FLOPS_PER_S = {"f32": 67e12, "bf16": 989e12, "f64": 34e12}
COPY_BYTES = 256 * 2**20
L2_BYTES = 1_220_608  # the K15e probe's X at T 298 (38,144 rows of 8 f32)
L2_BLOCKS_PER_SM = 8  # blocks of 256 threads: 2,048 threads an SM


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
    torch.cuda._sleep(SLEEP_CYCLES)
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


def chain_ms(fn, n: int = CHAIN, runs: int = CHAIN_RUNS) -> float:
    """Median over `runs` chains of n back-to-back launches of fn, each
    chain timed by one pair of CUDA events, its time over n: launches
    queued behind one another, so that one's tail may overlap the next
    one's start, as in maxwell_tpu/bench/exp_gather.py's timeit_chain.
    A device-side sleep queued first, four times as long as the host took
    to enqueue n launches, holds the chain back until all of it is queued;
    raises if the sleep ran out before the host had queued the last
    launch (the host's rate would be timed)."""
    if not torch.cuda.is_available():
        raise RuntimeError("chain_ms times on a CUDA device; none is visible")
    for _ in range(3):
        fn()
    host_s = 0.0  # the slower of two dry chains' enqueue
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_s = max(host_s, time.perf_counter() - t0)
    cycles = max(SLEEP_CYCLES, int(4 * host_s * CLOCK_HZ))
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        if e0.query():
            raise RuntimeError(f"chain_ms: the sleep of {cycles} cycles ran "
                               f"out before the host queued {n} launches")
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return statistics.median(times)


def device_ms(fn, n: int = 10, tries: int = 4) -> float:
    """Median of n calls of fn, each on its own: a device-side sleep (8
    times the host's enqueue time of one call, 10 ms at least) holds the
    call back until all of its launches are queued, and a pair of CUDA
    events times it. For a call of tens or hundreds of launches, whose
    host enqueue outlasts the device's work, this is the device's time;
    a chain of such calls would fill the card's launch queue while the
    sleep runs (chain_ms raises then). A call whose sleep ran out before
    the host had queued it (the host stalled) is timed again behind a
    sleep twice as long; after `tries` such calls this raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms times on a CUDA device; none is visible")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    cycles = max(SLEEP_CYCLES, int(8 * (time.perf_counter() - t0) * CLOCK_HZ))
    times = []
    while len(times) < n:
        for _ in range(tries):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            e0.record()
            fn()
            e1.record()
            queued = not e0.query()
            torch.cuda.synchronize()
            if queued:
                times.append(e0.elapsed_time(e1))
                break
            cycles *= 2
        else:
            raise RuntimeError(f"device_ms: the sleep ran out before the "
                               f"host queued the call, {tries} times (last "
                               f"{cycles // 2} cycles)")
    return statistics.median(times)


def wall_ms(fn, n: int = 3) -> float:
    """Median host time of n calls (after one warm-up), each between two
    synchronizes: for a call that synchronizes on its own, which the
    device-side sleep of device_ms cannot hold back."""
    if not torch.cuda.is_available():
        raise RuntimeError("wall_ms times on a CUDA device; none is visible")
    times = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def launch_floor_ms() -> float:
    """median_ms of an empty launch: below a few microseconds the launch
    itself sets a kernel's pace on that timer."""
    return median_ms(lambda: torch.cuda._sleep(0))


def chain_floor_ms() -> float:
    """chain_ms of an empty launch: what a launch costs in a chain."""
    return chain_ms(lambda: torch.cuda._sleep(0))


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


def l2_read_rate(device="cuda", nbytes: int = L2_BYTES) -> float:
    """Bytes per second the SMs read from L2: L2_BLOCKS_PER_SM blocks an SM
    each read the whole of one nbytes f32 buffer through L2 (ld.global.cg,
    L1 bypassed; the buffer stays L2-resident after the first launch),
    csrc/gather_probes.cu l2_read_f32; the rate a gather whose slices come
    from L2 cannot beat."""
    from maxwell_tpu_torch.kernels import gather_probes as gpr

    if torch.device(device).type != "cuda":
        raise ValueError(f"a device rate needs a CUDA device, not {device}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    x = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    out = torch.empty(sms * L2_BLOCKS_PER_SM, dtype=torch.float32,
                      device=device)
    ms = median_ms(lambda: gpr.l2_read(x, out))
    if out[0].item() != nbytes // 4:
        raise AssertionError("l2_read_f32 did not read the whole buffer")
    return out.numel() * nbytes / (ms * 1e-3)


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


def torch_csr(A, device, dtype=torch.float32):
    A = A.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data).to(dtype),
        size=A.shape, device=device,
    )
