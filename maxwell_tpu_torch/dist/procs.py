"""One process per device: the rank context of a distributed pencil, and
the launcher that starts the ranks.

The reference runs its distributed solvers under shard_map, one device per
shard. Here P processes (ranks) each hold D/P consecutive shards of a
row-sharded pencil (dist/partition.py) in the stacked view, and run the
single-device solvers on them in step (SPMD): every host decision is taken
on reduced, replicated values, so the ranks take the same branches.

    spawn(fn, procs, *args, device="cuda")

starts `procs` processes with torch.multiprocessing (spawn). Each joins a
gloo group over a FileStore in a fresh temporary directory (no TCP port to
choose; gloo's own connections stay on the loopback interface), calls
torch.set_num_threads(1), binds its device — cuda:(rank % device_count) on
the card, so all ranks share one card or spread over the cards of a host;
the CPU only when the caller asks for it — and runs fn(*args), its prints
sent to stderr. fn reads its rank from `current()`. Rank 0's return value
comes back to the caller. A rank that raises ends every rank, and spawn
raises RankError with the first error's traceback; a rank that dies ends
the run the same way, and a collective that waits TIMEOUT_S raises.

The gloo group carries host control only: the IPC handles of the halo
buffers, the barriers around an exchange, errors, and the small partial
sums of the reductions on host copies (RankGroup.all_gather).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

_CURRENT: "RankGroup | None" = None
TIMEOUT_S = 600  # a collective waits this long for the other ranks, then raises


class RankError(RuntimeError):
    """A rank of a spawn raised or died; the message holds its traceback."""


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's place among the ranks of a spawn."""

    rank: int
    procs: int
    device: torch.device

    def barrier(self) -> None:
        dist.barrier()

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(procs, *t.shape): every rank's t in rank order, on t's device,
        through host copies over the gloo group."""
        h = t.detach().to("cpu").contiguous()
        parts = [torch.empty_like(h) for _ in range(self.procs)]
        dist.all_gather(parts, h)
        return torch.stack(parts).to(t.device)

    def all_gather_object(self, obj) -> list:
        """Every rank's obj (picklable), in rank order."""
        out = [None] * self.procs
        dist.all_gather_object(out, obj)
        return out


def current() -> RankGroup | None:
    """The rank context of this process inside a spawn, else None."""
    return _CURRENT


def _worker(rank, procs, dev_type, tmp, fn, args):
    global _CURRENT
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    sys.stdout = sys.stderr  # a rank prints nothing on the caller's stdout
    try:
        if dev_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), procs),
            rank=rank, world_size=procs,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        _CURRENT = RankGroup(rank, procs, device)
        out = fn(*args)
        if dev_type == "cuda":
            torch.cuda.synchronize(device)
        # no rank leaves while another may still write into its buffers
        dist.barrier()
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        # the first error is the cause: a neighbour that then loses its
        # connection raises later
        with open(os.path.join(tmp, f"error.{rank}"), "wb") as f:
            pickle.dump((time.time(), rank, traceback.format_exc()), f)
        raise
    _CURRENT = None
    dist.destroy_process_group()


def spawn(fn, procs: int, *args, device: str | torch.device = "cuda"):
    """fn(*args) on `procs` ranks (see the module docstring); returns rank
    0's result. fn and args are pickled by reference: fn must be a
    module-level function of an importable module."""
    if procs < 1:
        raise ValueError(f"procs must be >= 1, got {procs}")
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spawn on cuda: no CUDA device is visible")
        from maxwell_tpu_torch.kernels import _build

        _build.build()  # once here, not by every rank at once
    elif dev_type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    tmp = tempfile.mkdtemp(prefix="maxwell_ranks_")
    try:
        try:
            torch.multiprocessing.spawn(
                _worker, args=(procs, dev_type, tmp, fn, args),
                nprocs=procs, join=True)
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            errors = []
            for name in os.listdir(tmp):
                if name.startswith("error."):
                    with open(os.path.join(tmp, name), "rb") as f:
                        errors.append(pickle.load(f))
            if not errors:
                raise RankError(str(e)) from e
            _, rank, trace = min(errors)
            raise RankError(f"rank {rank} of {procs} failed:\n{trace}") from e
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
