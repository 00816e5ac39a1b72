"""Phase timers, throughput and device traces (maxwell_tpu/utils/profiling.py).

`PhaseTimer` wraps setup/factorize/solve phases with wall-clock timing and
emits a JSON report with the reference's shape; `spmv_rate` converts an
apply time to nnz/s. `trace(logdir)` records a torch.profiler trace (CPU
activity, and CUDA activity when a card is visible) and writes it into
`logdir` as a Chrome trace (chrome://tracing, Perfetto); `top_kernels`
sums the device time of a trace's kernels by name.

    with trace("build/trace") as prof:
        lobpcg(pencil, ...)
    print(top_kernels(prof, 5))
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


class PhaseTimer:
    """Accumulating named phase timer.

    with timer.phase("assemble"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return json.dumps(
            {
                name: {"total_s": self.totals[name], "calls": self.counts[name]}
                for name in self.totals
            }
        )


def spmv_rate(nnz: int, seconds: float) -> float:
    """nnz/s for one operator apply."""
    return nnz / seconds if seconds > 0 else float("inf")


@contextlib.contextmanager
def trace(logdir: str | None):
    """torch.profiler over the block: CPU activity, plus CUDA activity when
    a card is visible (the device is synchronized before the trace ends).
    Yields the profiler; on exit writes `logdir/trace_<pid>_<n>.json`, a
    Chrome trace, and sets `prof.trace_path` to it (None: no file)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.trace_path = None
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        if logdir is None:
            return
        os.makedirs(logdir, exist_ok=True)
        n = len(os.listdir(logdir))
        prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
        prof.export_chrome_trace(prof.trace_path)


def top_kernels(prof, k: int | None = 5) -> list[dict]:
    """The k device kernels (None: all) of a finished trace with the most
    total device time: [{"name", "device_ms", "launches"}], largest first.
    Empty for a trace without device activity (a CPU run)."""
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    dev.sort(key=lambda e: -e.self_device_time_total)
    return [{"name": e.key, "device_ms": e.self_device_time_total / 1e3,
             "launches": e.count} for e in dev[:k]]


def device_busy_ms(prof) -> float:
    """The device time of every kernel of a finished trace, summed."""
    return sum(r["device_ms"] for r in top_kernels(prof, None))
