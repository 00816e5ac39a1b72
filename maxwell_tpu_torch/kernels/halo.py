"""Halo exchange of the row-sharded pencil (dist/partition.py): the CUDA
kernels' wrappers and their plain PyTorch versions.

    ring_shift(X, D, Hb, own, pad_rows)          every shard's halo section
    union_interior_overlap(A, X, D, Hb, streams) interior union SpMM of every
                                                 shard + the halo section

replace `ring_shift` (as `exchange_halos_rdma` calls it) and
`union_interior_overlap` of maxwell_tpu/kernels/halo_rdma.py, the TPU's
remote-DMA kernels. The D shards of a distributed pencil are held in the
stacked view: X is (D * Lb, m), shard d its rows [d * Lb, (d + 1) * Lb). A
shard's left halo is the previous shard's last Hb rows, its right halo the
next shard's first Hb rows; the chain ends get zeros, written, not left as
the buffer held them.

One process may hold all D shards (link=None), or P processes hold D / P
each (dist/procs.py), on one host or on several: then X is the rank's
(D/P * Lb, m) rows and `link`, a HaloLink, names the rank's place and owns
its exchange buffers. Each output shape has a registered buffer on every
rank, a cudaMalloc of its own, which an exchange returns, valid until the
rank's next exchange of that shape. Each side of a rank (the previous and
the next rank) takes a route of its own:
  - a neighbour on this host: the kernels push, the rank's first and last
    Hb rows going straight into the neighbour's registered buffer, which
    the neighbour exports as an IPC handle and this rank opens (traded
    over the gloo group, csrc/halo.cu);
  - a neighbour on another host, where an IPC handle does not open: the
    host-staged route. The rank copies its edge rows to the host and
    sends them with gloo's isend, and receives the neighbour's into a host
    buffer that it copies into its own registered buffer's slot. The
    kernels skip that side (a flag of their own). The rank posts these
    transfers before its local pushes and its launch, so they run beside
    them (beside K5's interior SpMM): the reference's DCN-first order.
Around each exchange the link synchronizes the stream and meets the other
ranks at a barrier, before (no neighbour still reads the buffer a push
overwrites) and after (no rank reads before every push has landed; the
host-staged copies land before the closing fence); `HaloLink.wait_s` is
the time spent in those barriers, `host_s` the time in the host-staged
transfers. The plain transport between ranks is a peer `copy_` into the
mapped buffers on the card (the host-staged route across hosts), and
gloo's isend/irecv on the CPU. The slab-sharded pencil
(dist/stencil_dist.py) takes the same link: its ghost-extended blocks are
registered buffers its neighbours push their edge planes into, and
`HaloLink.swap` carries one plane across each rank boundary each way,
each side by its route. The link counts what it moves: `bytes_pushed` to
the neighbours on its host, `bytes_across_hosts` to those on another, and
the reductions' all-gathers (`gathers`, `bytes_gathered`, `gather_s`). On
the card a gather goes through registered buffers too, each rank's mapped
in every rank, device to device, where every rank shares one host; across
hosts, and on the CPU, over gloo on host copies, in rank order, so it
gathers the same values.

`ring_shift` returns, per shard, [own Lb rows if own | left Hb | right Hb |
pad_rows zero rows] stacked over the shards: with own and pad_rows = b, the
halo-extended buffer of the blocked-ELL boundary product; without, the
[left | right] section of the union boundary product. One launch
(csrc/halo.cu) writes it for every shard; it only moves bytes (f32 or f64).
`ring_shift_plan` is the copy that launch makes: per shard at most five
segments, each a contiguous byte range of the output filled from one
contiguous range of X or with zeros, and the copy unit (16, 8 or 4 bytes)
that divides every segment's offsets and length. The kernel computes the
same segments itself and takes the unit from the wrapper. Its plain version
is slicing and torch.cat, which is also the "ppermute" transport of the
pencil, and the kernel's result equals it bit for bit.

`union_interior_overlap` takes the stacked interior layout of all shards
(one BELLUnion whose columns index the stacked X) and returns the interior
product of each requested value stream ("a", "b" or "ab") and the
[left | right] halo section, in one launch: the halo copy (the ring
shift's segment copy) runs in extra thread blocks beside the SpMM blocks,
whose per-tile arithmetic is the one-stream union kernel's
(csrc/bellunion_tile.cuh), so the products equal `bellunion_matmat`'s bit
for bit. "highest" precision, f32, as the TPU
kernel. Its plain version is the plain union product of each stream and the
plain ring shift.

A wrapper given CUDA tensors checks them and launches its kernel or raises.
Given CPU tensors it runs the plain version (`*_ref`). Each wrapper counts
its kernel launches in `.launches`, each plain version its calls in
`.calls`.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
import time

import torch

from maxwell_tpu_torch.kernels.bsr_spmm import _launch
from maxwell_tpu_torch.kernels.spmm import (
    _check_cuda,
    _live_pairs,
    _tables,
    _union_ref,
)
from maxwell_tpu_torch.sparse.bellunion import BELLUnion


def _shards(X: torch.Tensor, D: int, Hb: int):
    if X.dim() != 2 or X.shape[0] % D:
        raise ValueError(
            f"X must be ({D} * Lb, m), got {tuple(X.shape)}")
    Lb = X.shape[0] // D
    if Hb < 0:
        raise ValueError(f"halo depth {Hb} < 0")
    return Lb


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def window(X: torch.Tensor, D: int, Hb: int, gather: bool = False):
    """(D, Hb, m) left and right halos of the stacked X: shard d's left is
    rows [d Lb - Hb, d Lb) of X, its right rows [(d + 1) Lb, (d + 1) Lb +
    Hb), zero outside X. For Hb <= Lb these are the neighbours' last and
    first Hb rows, taken as slices; a deeper halo reaches further shards and
    is gathered from X padded by Hb zero rows on both ends (the reference's
    all_gather window), as is any halo with gather=True."""
    Lb = X.shape[0] // D
    m = X.shape[1]
    if Hb <= Lb and not gather:
        Xv = X.reshape(D, Lb, m)
        z = X.new_zeros((1, Hb, m))
        return torch.cat([z, Xv[:-1, Lb - Hb:]]), torch.cat([Xv[1:, :Hb], z])
    Xp = torch.nn.functional.pad(X, (0, 0, Hb, Hb))
    rows = (torch.arange(D, device=X.device) * Lb)[:, None] + torch.arange(
        Hb, device=X.device)
    return Xp[rows], Xp[rows + Lb + Hb]


def assemble(X: torch.Tensor, D: int, left: torch.Tensor,
             right: torch.Tensor, own: bool, pad_rows: int) -> torch.Tensor:
    """Per shard [own rows if own | left | right | pad_rows zeros],
    stacked: (D * rows, m)."""
    Lb, m = X.shape[0] // D, X.shape[1]
    parts = [X.reshape(D, Lb, m)] if own else []
    parts += [left, right]
    if pad_rows:
        parts.append(X.new_zeros((D, pad_rows, m)))
    return torch.cat(parts, dim=1).reshape(-1, m)


def ppermute(X: torch.Tensor, D: int, Hb: int, own: bool = False,
             pad_rows: int = 0, link: "HaloLink | None" = None
             ) -> torch.Tensor:
    """The plain transport (the reference's ppermute exchange): window and
    assemble; across processes (link) the link's plain transport. Not
    counted: it is a transport of its own, not only the ring shift's plain
    version."""
    if link is not None:
        return link.ppermute(X, own, pad_rows)
    _shards(X, D, Hb)
    return assemble(X, D, *window(X, D, Hb), own, pad_rows)


def ring_shift_ref(X: torch.Tensor, D: int, Hb: int, own: bool = False,
                   pad_rows: int = 0, link: "HaloLink | None" = None
                   ) -> torch.Tensor:
    """Plain version of ring_shift: the plain transport."""
    ring_shift_ref.calls += 1
    return ppermute(X, D, Hb, own, pad_rows, link)


def union_interior_overlap_ref(A: BELLUnion, X: torch.Tensor, D: int,
                               Hb: int, streams: str = "a",
                               link: "HaloLink | None" = None):
    """Plain version of union_interior_overlap: the plain union product of
    each stream, then the plain transport."""
    union_interior_overlap_ref.calls += 1
    return (*_union_ref(A, X, streams, "highest"),
            ppermute(X, D, Hb, link=link))


# ---------------------------------------------------------------------------
# The ring shift's copy plan
# ---------------------------------------------------------------------------

COPY_UNITS = (16, 8, 4)  # bytes, widest first


def shard_segments(d: int, D: int, Lb: int, Hb: int, own: bool,
                   pad_rows: int):
    """The five segments of shard d's output block, in rows: (dst, src,
    n), src -1 for n zero rows, dst counted from the start of the stacked
    output. In order: own rows (n = 0 without own); the left halo's rows
    before X's first row (zeros); its rows in X; the right halo's rows in
    X; its rows past X's end and the pad (zeros). csrc/halo.cu's
    ring_segment is the same table."""
    o = Lb if own else 0
    base = d * (o + 2 * Hb + pad_rows)
    zl = min(max(Hb - d * Lb, 0), Hb)
    rc = min(max((D - 1 - d) * Lb, 0), Hb)
    return ((base, d * Lb, o),
            (base + o, -1, zl),
            (base + o + zl, d * Lb - Hb + zl, Hb - zl),
            (base + o + Hb, (d + 1) * Lb, rc),
            (base + o + Hb + rc, -1, Hb - rc + pad_rows))


@functools.lru_cache(maxsize=64)
def ring_shift_plan(D: int, Lb: int, Hb: int, own: bool, pad_rows: int,
                    row_bytes: int):
    """(unit, segments) of the ring shift of a stacked (D Lb, m) X whose
    rows are row_bytes long: the non-empty segments of every shard as
    (dst, src, nbytes) byte ranges (src -1: zeros), and the widest copy
    unit of COPY_UNITS that divides every offset and length among them
    (the pointers may narrow it further: `copy_unit`)."""
    segs = []
    for d in range(D):
        for dst, src, n in shard_segments(d, D, Lb, Hb, own, pad_rows):
            if n > 0:
                segs.append((dst * row_bytes,
                             -1 if src < 0 else src * row_bytes,
                             n * row_bytes))
    g = 0
    for dst, src, n in segs:
        g = math.gcd(g, dst, max(src, 0), n)
    unit = next((u for u in COPY_UNITS if g % u == 0), None)
    if unit is None:
        raise ValueError(f"rows of {row_bytes} bytes have no 4-byte copy "
                         "unit")
    return unit, tuple(segs)


def copy_unit(plan_unit: int, *tensors: torch.Tensor) -> int:
    """The plan's unit, narrowed until it divides every tensor's address."""
    unit = plan_unit
    while unit > COPY_UNITS[-1] and any(t.data_ptr() % unit
                                        for t in tensors):
        unit //= 2
    return unit


# ---------------------------------------------------------------------------
# Across processes
# ---------------------------------------------------------------------------

IPC_HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t), checked in csrc/halo.cu


def _ipc(name: str, *args) -> None:
    from maxwell_tpu_torch.kernels import _build

    rc = getattr(_build.load(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


class _DevicePointer:
    """A device pointer as __cuda_array_interface__, for torch.as_tensor
    (a view; the memory stays the HaloLink's)."""

    def __init__(self, ptr: int, shape, dtype: torch.dtype):
        typestr = {torch.float32: "<f4", torch.float64: "<f8"}[dtype]
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": typestr,
            "data": (ptr, False), "version": 2, "strides": None}


def _view(ptr: int, shape, dtype, device) -> torch.Tensor:
    return torch.as_tensor(_DevicePointer(ptr, shape, dtype), device=device)


@dataclasses.dataclass
class _Buffers:
    out: torch.Tensor
    left: torch.Tensor | None  # the previous rank's out, mapped here
    right: torch.Tensor | None  # the next rank's out


class HaloLink:
    """A rank's place in the halo exchange of a pencil of D shards held by
    `group.procs` processes (dist/procs.py RankGroup), D / procs
    consecutive shards each, Lb rows a shard, halos Hb rows deep: its
    registered exchange buffers (on the card) and the order around an
    exchange. close() releases the buffers; every rank calls it."""

    def __init__(self, group, D: int, Lb: int, Hb: int):
        if D % group.procs:
            raise ValueError(f"{D} shards do not divide over {group.procs} "
                             "processes")
        self.group = group
        self.D, self.Lb, self.Hb = D, Lb, Hb
        self.Dl = D // group.procs
        self.d0 = group.rank * self.Dl
        self._buffers: dict[tuple, _Buffers] = {}
        self._gathers: dict[tuple, list] = {}  # every rank's, mapped here
        self._owned: list[int] = []  # pointers this rank allocated
        self._opened: list[int] = []  # neighbours' pointers it mapped
        r = group.rank
        # which sides lead to another host (the host-staged route)
        self.crosses = {side: 0 <= q < group.procs
                        and group.host_of(q) != group.host
                        for side, q in (("left", r - 1), ("right", r + 1))}
        self.exchanges = 0  # exchanges through the registered buffers
        self.wait_s = 0.0  # host seconds in their barriers
        self.bytes_pushed = 0  # bytes this rank sent its neighbours on its host
        self.bytes_across_hosts = 0  # bytes it sent to those on another host
        self.host_s = 0.0  # host seconds in the host-staged transfers
        self.gathers = 0  # all-gathers of partials (the reductions)
        self.bytes_gathered = 0  # the bytes those gathers returned
        self.gather_s = 0.0  # host seconds in them

    @property
    def first(self) -> bool:
        return self.d0 == 0

    @property
    def last(self) -> bool:
        return self.d0 + self.Dl == self.D

    @property
    def routes(self) -> dict:
        """{"left", "right"}: each side's route, None at a chain end; on
        the card "ipc" (a neighbour on this host) or "host_staged" (one on
        another host), on the CPU "gloo"."""
        ends = {"left": self.first, "right": self.last}
        cuda = self.group.device.type == "cuda"
        return {side: None if ends[side] else "gloo" if not cuda
                else "host_staged" if self.crosses[side] else "ipc"
                for side in ends}

    def buffers(self, rows: int, m: int, dtype: torch.dtype) -> _Buffers:
        """The registered (Dl * rows, m) output of this rank and its
        neighbours' (None at a chain end), allocated and exchanged on first
        use: a collective, which every rank reaches in the same order (the
        ranks run the same program)."""
        return self._register((rows, m, dtype), (self.Dl * rows, m), dtype)

    def _register(self, key, shape, dtype: torch.dtype) -> _Buffers:
        """The registered buffer of this rank under `key`, of `shape`, and
        its neighbours' mapped (see buffers)."""
        if key not in self._buffers:
            r = self.group.rank
            views = self._alloc(shape, dtype, [
                q for q, side in ((r - 1, "left"), (r + 1, "right"))
                if not self.crosses[side]])
            self._buffers[key] = _Buffers(views[r], views.get(r - 1),
                                          views.get(r + 1))
        return self._buffers[key]

    def _alloc(self, shape, dtype: torch.dtype, peers) -> dict:
        """{rank: view}: a new buffer of this rank (a cudaMalloc of its
        own, exported as an IPC handle) and the buffers of the ranks
        `peers` (those that exist, all on this host) mapped here. A
        collective: every rank allocates and trades its handle over the
        gloo group, whatever it maps."""
        dev = self.group.device
        if dev.type != "cuda":
            raise ValueError("registered exchange buffers live on the card")
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        _ipc("ipc_alloc", nbytes, dev.index, ctypes.byref(ptr), handle)
        self._owned.append(ptr.value)
        handles = self.group.all_gather_object(handle.raw)
        views = {self.group.rank: _view(ptr.value, shape, dtype, dev)}
        for r in peers:
            if r == self.group.rank or not 0 <= r < self.group.procs:
                continue
            peer = ctypes.c_void_p()
            buf = ctypes.create_string_buffer(handles[r], IPC_HANDLE_BYTES)
            _ipc("ipc_open", buf, dev.index, ctypes.byref(peer))
            self._opened.append(peer.value)
            views[r] = _view(peer.value, shape, dtype, dev)
        return views

    def peer(self, bufs: _Buffers, side: str) -> torch.Tensor:
        """bufs' neighbour buffer on `side`, which must be a neighbour on
        this host (route "ipc"): raises where its buffer is not mapped, so
        no side of an exchange is skipped unseen."""
        t = getattr(bufs, side)
        if t is None:
            raise RuntimeError(
                f"rank {self.group.rank}: the {side} neighbour shares this "
                "host but its buffer is not mapped")
        return t

    def pushes(self) -> tuple[int, int]:
        """(left, right): 1 where a launch pushes that side into the
        neighbour's mapped buffer (a neighbour on this host), 0 at a chain
        end or where the host-staged route carries it."""
        return (int(not self.first and not self.crosses["left"]),
                int(not self.last and not self.crosses["right"]))

    def count_push(self, nbytes: int) -> None:
        """Count `nbytes` sent to each neighbour this rank has: into
        bytes_pushed on this host, bytes_across_hosts to another."""
        for side, end in (("left", self.first), ("right", self.last)):
            if end:
                continue
            if self.crosses[side]:
                self.bytes_across_hosts += nbytes
            else:
                self.bytes_pushed += nbytes

    def post(self, send: dict, into: dict):
        """Start the host-staged transfers of an exchange, inside its
        fences and before anything else of it: for each side that crosses
        hosts, send[side] (a tensor on the card) copied to the host and
        sent to that neighbour, and the neighbour's rows received into a
        host buffer, to land in the views into[side] (this rank's
        registered buffer, in order). Returns what `land` completes."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        r = self.group.rank
        ops, landing = [], []
        for side, q in (("left", r - 1), ("right", r + 1)):
            if not self.crosses[side]:
                continue
            h = send[side].detach().to("cpu").reshape(-1)
            buf = torch.empty(sum(v.numel() for v in into[side]),
                              dtype=h.dtype)
            ops += [dist.P2POp(dist.isend, h, q),
                    dist.P2POp(dist.irecv, buf, q)]
            landing.append((buf, into[side], h))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        self.host_s += time.perf_counter() - t0
        return reqs, landing

    def land(self, pending) -> None:
        """Wait for the transfers `post` started and copy what came into
        the registered buffer (on the stream, before the closing fence)."""
        t0 = time.perf_counter()
        reqs, landing = pending
        for req in reqs:
            req.wait()
        for buf, views, _ in landing:
            start = 0
            for v in views:
                v.copy_(buf[start:start + v.numel()].view(v.shape))
                start += v.numel()
        self.host_s += time.perf_counter() - t0

    def post_halo(self, X: torch.Tensor, out: torch.Tensor, own_rows: int,
                  rows: int):
        """post() for a halo section: this rank's first and last Hb rows
        of X, into out's slots, the first local shard's left halo and the
        last one's right (out: per shard [own_rows | left Hb | right Hb |
        ...], `rows` rows)."""
        Hb, o = self.Hb, own_rows
        ov = out.view(self.Dl, rows, X.shape[1])
        return self.post({"left": X[:Hb], "right": X[-Hb:]},
                         {"left": [ov[0, o:o + Hb]],
                          "right": [ov[-1, o + Hb:o + 2 * Hb]]})

    @contextlib.contextmanager
    def exchange(self):
        """The context of a push into the neighbours' registered buffers: a
        fence before and after (counted in `exchanges`)."""
        self.fence()
        yield
        self.fence()
        self.exchanges += 1

    def fence(self) -> None:
        """Synchronize this rank's stream, then meet every rank at a
        barrier (timed into wait_s)."""
        if self.group.device.type == "cuda":
            torch.cuda.current_stream(self.group.device).synchronize()
        t0 = time.perf_counter()
        self.group.barrier()
        self.wait_s += time.perf_counter() - t0

    def gather(self, X: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, stacked: the (D * Lb, ...) global X (counted
        in gathers, bytes_gathered and gather_s). A CUDA X where every rank
        shares one host goes through registered buffers that every rank
        maps (`_gather_on_card`); otherwise over gloo (host copies)."""
        t0 = time.perf_counter()
        on_card = X.device.type == "cuda" and self.group.hosts == 1
        out = (self._gather_on_card(X) if on_card
               else self.group.all_gather(X)).reshape(-1, *X.shape[1:])
        self.gather_s += time.perf_counter() - t0
        self.gathers += 1
        self.bytes_gathered += out.numel() * out.element_size()
        return out

    def _gather_on_card(self, X: torch.Tensor) -> torch.Tensor:
        """(procs, *X.shape): every rank's X, device to device. Each rank
        copies its X into its own registered buffer of X's shape between
        two synchronize-and-barrier steps, then copies every rank's buffer
        (mapped in every rank) into a new tensor on its stream. The next
        gather of that shape starts with a synchronize and a barrier, so
        no rank overwrites a buffer another still reads."""
        X = X.contiguous()
        views = self._mapped(("gather", tuple(X.shape), X.dtype), X.shape,
                             X.dtype)
        stream = torch.cuda.current_stream(self.group.device)
        stream.synchronize()
        self.group.barrier()
        views[self.group.rank].copy_(X)
        stream.synchronize()
        self.group.barrier()
        out = X.new_empty((self.group.procs, *X.shape))
        for r, view in enumerate(views):
            out[r].copy_(view)
        return out

    def _mapped(self, key, shape, dtype: torch.dtype) -> list:
        """[every rank's registered buffer under `key`], in rank order,
        each mapped here (this rank's own at its rank): allocated and
        exchanged on first use, a collective as buffers()."""
        if key not in self._gathers:
            views = self._alloc(shape, dtype, range(self.group.procs))
            self._gathers[key] = [views[r] for r in range(self.group.procs)]
        return self._gathers[key]

    def swap(self, first: torch.Tensor, last: torch.Tensor):
        """(the previous rank's `last`, the next rank's `first`), zeros at
        the chain ends: what crosses each rank boundary in each direction.
        Every rank passes tensors of the same shapes. On the CPU gloo
        isend/irecv into new tensors; on the card, between two fences, a
        peer copy_ of each into the neighbour's registered two-slot buffer
        on this host (the host-staged route into this rank's own slots
        across hosts, posted first), and views of this rank's slots
        returned (valid until its next swap of that size)."""
        self.count_push(first.numel() * first.element_size())
        if first.device.type == "cpu":
            return self._sendrecv(first, last)
        shape, k = first.shape, first.numel()
        bufs = self._register(("swap", k, first.dtype), (2, k), first.dtype)
        with self.exchange():
            pending = self.post({"left": first, "right": last},
                                {"left": [bufs.out[0]],
                                 "right": [bufs.out[1]]})
            if self.first:
                bufs.out[0].zero_()
            elif not self.crosses["left"]:
                self.peer(bufs, "left")[1].copy_(first.reshape(-1))
            if self.last:
                bufs.out[1].zero_()
            elif not self.crosses["right"]:
                self.peer(bufs, "right")[0].copy_(last.reshape(-1))
            self.land(pending)
        return bufs.out[0].view(shape), bufs.out[1].view(shape)

    def _sendrecv(self, first: torch.Tensor, last: torch.Tensor):
        """swap over gloo isend/irecv (the CPU's plain transport), the
        sides that cross hosts posted first."""
        import torch.distributed as dist

        r = self.group.rank
        left, right = last.new_zeros(last.shape), first.new_zeros(first.shape)
        sides = []
        if not self.first:
            sides.append(("left", [dist.P2POp(dist.isend, first.contiguous(),
                                              r - 1),
                                   dist.P2POp(dist.irecv, left, r - 1)]))
        if not self.last:
            sides.append(("right", [dist.P2POp(dist.isend, last.contiguous(),
                                               r + 1),
                                    dist.P2POp(dist.irecv, right, r + 1)]))
        sides.sort(key=lambda side: not self.crosses[side[0]])
        ops = [op for _, pair in sides for op in pair]
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return left, right

    def ppermute(self, X: torch.Tensor, own: bool, pad_rows: int):
        """The plain transport between ranks: per local shard [own rows if
        own | left Hb | right Hb | pad_rows zeros]. On the CPU over gloo
        into a new tensor; on the card, between two fences, a peer copy_
        of this rank's first and last Hb rows into its neighbours'
        registered buffers on this host (across hosts the host-staged
        route, posted first), the rest written locally."""
        Dl, Lb, Hb = self.Dl, self.Lb, self.Hb
        m = X.shape[1]
        Xv = X.reshape(Dl, Lb, m)
        if X.device.type == "cpu":
            left, right = self.swap(X[:Hb], X[-Hb:])
            return assemble(X, Dl, torch.cat([left[None], Xv[:-1, Lb - Hb:]]),
                            torch.cat([Xv[1:, :Hb], right[None]]), own,
                            pad_rows)
        o = Lb if own else 0
        rows = o + 2 * Hb + pad_rows
        bufs = self.buffers(rows, m, X.dtype)
        ov = bufs.out.view(Dl, rows, m)
        self.count_push(Hb * m * X.element_size())
        with self.exchange():
            pending = self.post_halo(X, bufs.out, o, rows)
            if own:
                ov[:, :o].copy_(Xv)
            ov[1:, o:o + Hb].copy_(Xv[:-1, Lb - Hb:])
            ov[:-1, o + Hb:o + 2 * Hb].copy_(Xv[1:, :Hb])
            ov[:, o + 2 * Hb:].zero_()
            if self.first:
                ov[0, o:o + Hb].zero_()
            elif not self.crosses["left"]:
                self.peer(bufs, "left").view(Dl, rows, m)[
                    -1, o + Hb:o + 2 * Hb].copy_(Xv[0, :Hb])
            if self.last:
                ov[-1, o + Hb:o + 2 * Hb].zero_()
            elif not self.crosses["right"]:
                self.peer(bufs, "right").view(Dl, rows, m)[
                    0, o:o + Hb].copy_(Xv[-1, Lb - Hb:])
            self.land(pending)
        return bufs.out

    def close(self) -> None:
        """Unmap the neighbours' buffers, then (after every rank has) free
        this rank's own. A collective."""
        if not (self._owned or self._opened):
            return
        dev = self.group.device.index
        self.fence()
        for ptr in self._opened:
            _ipc("ipc_close", ptr, dev)
        self.group.barrier()
        for ptr in self._owned:
            _ipc("ipc_free", ptr, dev)
        self._buffers.clear()
        self._gathers.clear()
        self._owned.clear()
        self._opened.clear()


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _local(X: torch.Tensor, D: int, Hb: int, link: HaloLink | None):
    """(Dl, d0, Lb) of the shards X holds: all D, or the link's."""
    if link is None:
        return D, 0, _shards(X, D, Hb)
    if (D, Hb) != (link.D, link.Hb):
        raise ValueError(f"D {D}, Hb {Hb}: the link has {link.D}, {link.Hb}")
    if X.dim() != 2 or X.shape[0] != link.Dl * link.Lb:
        raise ValueError(f"X must be ({link.Dl} * {link.Lb}, m), got "
                         f"{tuple(X.shape)}")
    return link.Dl, link.d0, link.Lb


def _output(X: torch.Tensor, rows: int, Dl: int, link: HaloLink | None):
    """(out, the neighbours' out pointers, the per-side push flags, the
    tensors the copy unit must divide): a new (Dl * rows, m) tensor in one
    process, the link's registered buffers across processes. The flags
    come from the link's routes (HaloLink.pushes), not from the pointers,
    so the kernel refuses a side on this host whose buffer is not
    mapped."""
    if link is None:
        out = torch.empty((Dl * rows, X.shape[1]), dtype=X.dtype,
                          device=X.device)
        return out, (None, None), (0, 0), (X, out)
    bufs = link.buffers(rows, X.shape[1], X.dtype)
    peers = (bufs.left, bufs.right)
    return (bufs.out, tuple(None if t is None else t.data_ptr()
                            for t in peers),
            link.pushes(),
            (X, bufs.out, *(t for t in peers if t is not None)))


@contextlib.contextmanager
def _fenced(link: HaloLink | None, X: torch.Tensor, out: torch.Tensor,
            own_rows: int, rows: int):
    """Around a launch that pushes into the neighbours' buffers: a fence
    before and after, and inside them the host-staged sides posted before
    the launch and landed after it (nothing in one process)."""
    if link is None:
        yield
        return
    with link.exchange():
        pending = link.post_halo(X, out, own_rows, rows)
        yield
        link.land(pending)


def ring_shift(X: torch.Tensor, D: int, Hb: int, own: bool = False,
               pad_rows: int = 0, link: HaloLink | None = None
               ) -> torch.Tensor:
    """Every shard's halo section of the stacked X (Dl * Lb, m), f32 or f64,
    in one launch: per shard [own rows if own | left Hb | right Hb |
    pad_rows zeros], stacked, (Dl * rows, m). One process: Dl = D and a new
    tensor. Across processes (link): this rank's Dl = D / P shards, its
    first and last rows pushed into its neighbours' registered buffers, and
    its own registered buffer returned."""
    if X.device.type == "cpu":
        return ring_shift_ref(X, D, Hb, own, pad_rows, link)
    Dl, d0, Lb = _local(X, D, Hb, link)
    if X.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ring_shift takes f32 or f64, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    rows = (Lb if own else 0) + 2 * Hb + pad_rows
    out, peers, push, aligned = _output(X, rows, Dl, link)
    row_bytes = X.shape[1] * X.element_size()
    unit = copy_unit(ring_shift_plan(D, Lb, Hb, own, pad_rows, row_bytes)[0],
                     *aligned)
    if link is not None:
        link.count_push(Hb * row_bytes)
    with _fenced(link, X, out, Lb if own else 0, rows):
        _launch("ring_shift", X, X.data_ptr(), out.data_ptr(), *peers, D,
                d0, Dl, Lb, Hb, row_bytes, pad_rows, int(own), *push, unit)
        ring_shift.launches += 1
    return out


def union_interior_overlap(A: BELLUnion, X: torch.Tensor, D: int, Hb: int,
                           streams: str = "a", link: HaloLink | None = None):
    """(Y_s for each stream s of `streams`, halo): A the stacked interior
    layout of the Dl shards X holds (columns index the stacked X), X
    (Dl * Lb, m) f32; halo the (Dl * 2Hb, m) [left | right] section
    (ring_shift without own rows), written by copy blocks of the same
    launch; across processes (link) pushed as ring_shift pushes, into the
    registered buffers."""
    if X.device.type == "cpu":
        return union_interior_overlap_ref(A, X, D, Hb, streams, link)
    Dl, d0, Lb = _local(X, D, Hb, link)
    if streams not in ("a", "b", "ab"):
        raise ValueError(f"streams must be 'a', 'b' or 'ab', got {streams!r}")
    pairs = _live_pairs(A, streams, "highest")
    _check_cuda(A, X, pairs)
    if X.shape[0] != A.n_cols_padded or A.n_padded != X.shape[0]:
        raise ValueError(
            f"X has {X.shape[0]} rows, the stacked interior layout "
            f"{A.n_padded} x {A.n_cols_padded}")
    m = X.shape[1]
    Ys = [torch.empty((A.n_padded, m), dtype=torch.float32, device=X.device)
          for _ in streams]
    halo, peers, push, aligned = _output(X, 2 * Hb, Dl, link)
    vb = pairs[1][0].data_ptr() if len(pairs) == 2 else None
    yb = Ys[1].data_ptr() if len(Ys) == 2 else None
    unit = copy_unit(ring_shift_plan(D, Lb, Hb, False, 0, m * 4)[0],
                     *aligned)
    if link is not None:
        link.count_push(Hb * m * 4)
    with _fenced(link, X, halo, 0, 2 * Hb):
        _launch("union_overlap_f32", X, pairs[0][0].data_ptr(), vb,
                *_tables(A), X.data_ptr(), Ys[0].data_ptr(), yb,
                halo.data_ptr(), *peers, len(streams) - 1, A.n_tiles, m,
                A.cl, A.b, A.live.x_max, D, d0, Dl, Lb, Hb, *push, unit)
        union_interior_overlap.launches += 1
    return (*Ys, halo)


KERNELS = (ring_shift, union_interior_overlap)
PLAIN = (ring_shift_ref, union_interior_overlap_ref)


def reset_counts() -> None:
    """Zero every kernel's launch count and every plain version's call
    count."""
    for fn in KERNELS:
        fn.launches = 0
    for fn in PLAIN:
        fn.calls = 0


def counts() -> dict:
    """{name: launches} of the kernels and {name: calls} of the plain
    versions."""
    return {
        **{fn.__name__: fn.launches for fn in KERNELS},
        **{fn.__name__: fn.calls for fn in PLAIN},
    }


reset_counts()
