"""One process per device: the rank context of a distributed pencil, and
the launcher that starts the ranks, on one host or on several.

The reference runs its distributed solvers under shard_map, one device per
shard. Here P processes (ranks) each hold D/P consecutive shards of a
row-sharded pencil (dist/partition.py) in the stacked view, and run the
single-device solvers on them in step (SPMD): every host decision is taken
on reduced, replicated values, so the ranks take the same branches.

    spawn(fn, procs, *args, device="cuda", rendezvous=None)

starts `procs` processes on this host with torch.multiprocessing (spawn).
Each calls torch.set_num_threads(1), binds its device — cuda:(local rank %
device_count) on the card, so the host's ranks share one card or spread
over its cards; the CPU only when the caller asks for it — joins the gloo
group and runs fn(*args), its prints sent to stderr. fn reads its rank
from `current()`.

One host (no rendezvous): the ranks meet through a FileStore in a fresh
temporary directory (no TCP port to choose) and gloo's connections stay on
the loopback interface. Rank 0's return value comes back to the caller.

H hosts: each host's launcher calls spawn with the same `procs` and a
Rendezvous(addr, port, hosts=H, host=h) of its own h. Host 0's launcher
holds a torch.distributed.TCPStore at addr:port, and every rank of every
host joins one gloo group over it. Rank = h * procs + local rank, hosts-
major, as the reference orders its devices (maxwell_tpu/dist/mesh.py
make_mesh). gloo binds the interface through which this host reaches addr
(GLOO_SOCKET_IFNAME, unless the caller set it). Each launcher returns the
result of its host's first rank: rank 0's on host 0.

A rank that raises ends every rank: spawn raises RankError with the first
error's traceback on its own host, and across hosts that launcher posts it
to the store, where the other launchers find it within a second, end their
ranks and raise RankError with it too. A rank that dies ends the run the
same way, and a collective that waits TIMEOUT_S raises.

    run_hosts(fn, hosts, procs, *args, device="cuda")

runs H host groups on this one machine: H launcher processes, each calling
spawn with its own h, meeting at a TCPStore on 127.0.0.1 at a free port.
It is how the tests and the smoke hold the cross-host road on one host
(their links between groups take the cross-host transport, which does not
ask whether the other host is this one).

The gloo group carries host control only: the IPC handles of the halo
buffers, the barriers around an exchange, errors, the small partial sums
of the reductions on host copies (RankGroup.all_gather), and the halo rows
of the links that cross hosts (kernels/halo.py HaloLink).
"""

from __future__ import annotations

import dataclasses
import datetime
import fcntl
import multiprocessing
import os
import pickle
import shutil
import socket
import struct
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

_CURRENT: "RankGroup | None" = None
TIMEOUT_S = 600  # a collective waits this long for the other ranks, then raises
POLL_S = 0.5  # how often a launcher looks for the other hosts' errors
DONE_S = 60  # how long host 0 keeps the store for the others after the end


class RankError(RuntimeError):
    """A rank of a spawn raised or died; the message holds its traceback.
    From run_hosts, `hosts` holds each launcher's outcome."""

    hosts: list | None = None


@dataclasses.dataclass(frozen=True)
class Rendezvous:
    """Where the launchers of `hosts` hosts meet: host 0's launcher holds a
    TCPStore at addr:port; `host` is this launcher's index."""

    addr: str
    port: int
    hosts: int
    host: int

    def __post_init__(self):
        if self.hosts < 1 or not 0 <= self.host < self.hosts:
            raise ValueError(f"host {self.host} of {self.hosts} hosts")
        if not 0 < self.port < 65536:
            raise ValueError(f"port {self.port}")


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's place among the ranks of a spawn: `procs` ranks in
    all, `hosts` hosts of procs / hosts ranks each, this one on `host`."""

    rank: int
    procs: int
    device: torch.device
    host: int = 0
    hosts: int = 1

    @property
    def per_host(self) -> int:
        return self.procs // self.hosts

    def host_of(self, rank: int) -> int:
        """The host of `rank` (hosts-major ranks)."""
        return rank // self.per_host

    @property
    def host_ranks(self) -> range:
        """The ranks that share this rank's host."""
        return range(self.host * self.per_host, (self.host + 1)
                     * self.per_host)

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


_SIOCGIFADDR = 0x8915


def _interface_to(addr: str, port: int) -> str | None:
    """The name of the interface whose IPv4 address this host uses to
    reach addr (a UDP socket's connect sends nothing), or None."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((addr, port))
        mine = s.getsockname()[0]
        for _, name in socket.if_nameindex():
            try:
                req = struct.pack("256s", name.encode()[:15])
                got = socket.inet_ntoa(
                    fcntl.ioctl(s.fileno(), _SIOCGIFADDR, req)[20:24])
            except OSError:  # no IPv4 address on this interface
                continue
            if got == mine:
                return name
    return None


def _client(rdv: Rendezvous) -> dist.TCPStore:
    return dist.TCPStore(rdv.addr, rdv.port, is_master=False,
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _worker(local, procs, dev_type, tmp, fn, args, rdv):
    global _CURRENT
    torch.set_num_threads(1)
    sys.stdout = sys.stderr  # a rank prints nothing on the caller's stdout
    rank = local
    try:
        if rdv is None:
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
            rank, world, host, hosts = local, procs, 0, 1
            store = dist.FileStore(os.path.join(tmp, "store"), procs)
        else:
            iface = _interface_to(rdv.addr, rdv.port)
            if iface is not None:
                os.environ.setdefault("GLOO_SOCKET_IFNAME", iface)
            rank, world = rdv.host * procs + local, rdv.hosts * procs
            host, hosts = rdv.host, rdv.hosts
            store = dist.PrefixStore("ranks", _client(rdv))
        if dev_type == "cuda":
            device = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        _CURRENT = RankGroup(rank, world, device, host, hosts)
        out = fn(*args)
        if dev_type == "cuda":
            torch.cuda.synchronize(device)
        # no rank leaves while another may still write into its buffers
        dist.barrier()
        if local == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        # the first error is the cause: a neighbour that then loses its
        # connection raises later
        with open(os.path.join(tmp, f"error.{local}"), "wb") as f:
            pickle.dump((time.time(), rank, traceback.format_exc()), f)
        raise
    _CURRENT = None
    dist.destroy_process_group()


def _local_error(tmp, procs, hosts, host, exc) -> RankError:
    """The RankError of this host's first failed rank (its traceback), or
    of the launcher's exception where no rank left one."""
    errors = []
    for name in os.listdir(tmp):
        if name.startswith("error."):
            with open(os.path.join(tmp, name), "rb") as f:
                errors.append(pickle.load(f))
    where = f" on host {host}" if hosts > 1 else ""
    if not errors:
        return RankError(f"{exc}{where}")
    _, rank, trace = min(errors)
    return RankError(f"rank {rank} of {procs * hosts}{where} failed:\n"
                     f"{trace}")


def _stop(ctx) -> None:
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
    for p in ctx.processes:
        p.join(10)


def _wait(ctx, store, rdv, tmp, procs) -> None:
    """Join this host's ranks; across hosts also watch the store for an
    error another launcher posted (then end the ranks here and raise it),
    and post this host's own error there before raising it, unless
    another host's came first (this host's ranks then failed for it)."""
    while True:
        try:
            if ctx.join(timeout=POLL_S if store else None):
                return
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            if store is not None and store.check(["error"]):
                raise RankError(store.get("error").decode()) from e
            err = _local_error(tmp, procs, rdv.hosts if rdv else 1,
                               rdv.host if rdv else 0, e)
            if store is not None:
                store.set("error", str(err))
            raise err from e
        if store is not None and store.check(["error"]):
            _stop(ctx)
            raise RankError(store.get("error").decode())


def spawn(fn, procs: int, *args, device: str | torch.device = "cuda",
          rendezvous: Rendezvous | None = None):
    """fn(*args) on `procs` ranks of this host (see the module docstring);
    returns the result of the host's first rank (rank 0's on host 0). fn
    and args are pickled by reference: fn must be a module-level function
    of an importable module."""
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
    store = None
    if rendezvous is not None:
        store = (dist.TCPStore(rendezvous.addr, rendezvous.port,
                               is_master=True, wait_for_workers=False,
                               timeout=datetime.timedelta(seconds=TIMEOUT_S))
                 if rendezvous.host == 0 else _client(rendezvous))
    tmp = tempfile.mkdtemp(prefix="maxwell_ranks_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _worker, args=(procs, dev_type, tmp, fn, args, rendezvous),
            nprocs=procs, join=False, start_method="spawn")
        try:
            _wait(ctx, store, rendezvous, tmp, procs)
        finally:
            _stop(ctx)
        if store is not None:
            # host 0 holds the store until every host's launcher has seen
            # its ranks end (they passed the last barrier together), or
            # DONE_S has passed
            store.add("done", 1)
            deadline = time.monotonic() + DONE_S
            while (rendezvous.host == 0
                   and store.add("done", 0) < rendezvous.hosts
                   and time.monotonic() < deadline):
                time.sleep(POLL_S / 10)
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def free_port(addr: str = "127.0.0.1") -> int:
    """A TCP port on addr that no socket holds now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((addr, 0))
        return s.getsockname()[1]


def _launcher(out_path, fn, procs, args, device, rdv):
    """One host's launcher of run_hosts: spawn with its rendezvous, its
    outcome pickled to out_path."""
    t0 = time.perf_counter()
    try:
        res = spawn(fn, procs, *args, device=device, rendezvous=rdv)
        outcome = {"ok": True, "result": res}
    except Exception as e:  # the launcher's boundary: report, then exit
        outcome = {"ok": False, "error": type(e).__name__,
                   "message": str(e)}
    outcome.update(host=rdv.host, seconds=time.perf_counter() - t0)
    with open(out_path, "wb") as f:
        pickle.dump(outcome, f)


def run_hosts(fn, hosts: int, procs: int, *args,
              device: str | torch.device = "cuda",
              addr: str = "127.0.0.1", timeout: float = TIMEOUT_S + 60):
    """fn(*args) on `hosts` host groups of `procs` ranks each, on this
    machine: one launcher process a host, meeting at a TCPStore on addr
    at a free port (see the module docstring). Returns rank 0's result.
    If a launcher fails, raises RankError whose `hosts` lists every
    launcher's outcome ({"host", "ok", "seconds", and "error", "message"
    where it raised})."""
    if torch.device(device).type == "cuda":
        from maxwell_tpu_torch.kernels import _build

        _build.build()  # once here, before the launchers start
    port = free_port(addr)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="maxwell_hosts_")
    try:
        launchers = []
        for h in range(hosts):
            p = ctx.Process(target=_launcher, args=(
                os.path.join(tmp, f"host.{h}"), fn, procs, args,
                str(device), Rendezvous(addr, port, hosts, h)))
            p.start()
            launchers.append(p)
        deadline = time.monotonic() + timeout
        for p in launchers:
            p.join(max(deadline - time.monotonic(), 0.0))
        outcomes = []
        for h, p in enumerate(launchers):
            if p.is_alive():
                p.terminate()
                p.join(10)
            path = os.path.join(tmp, f"host.{h}")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    outcomes.append(pickle.load(f))
            else:
                outcomes.append({"host": h, "ok": False, "error": "exit",
                                 "message": f"exit code {p.exitcode}",
                                 "seconds": None})
        if not all(o["ok"] for o in outcomes):
            failed = [o for o in outcomes if not o["ok"]]
            err = RankError("\n".join(
                f"host {o['host']}'s launcher: {o['error']}: {o['message']}"
                for o in failed))
            err.hosts = [{k: v for k, v in o.items() if k != "result"}
                         for o in outcomes]
            raise err
        return outcomes[0]["result"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
