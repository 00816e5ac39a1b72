"""Halo exchange of the row-sharded pencil (dist/partition.py): the CUDA
kernels' wrappers and their plain PyTorch versions.

    ring_shift(X, D, Hb, own, pad_rows)          every shard's halo section
    union_interior_overlap(A, X, D, Hb, streams) interior union SpMM of every
                                                 shard + the halo section

replace `ring_shift` (as `exchange_halos_rdma` calls it) and
`union_interior_overlap` of maxwell_tpu/kernels/halo_rdma.py, the TPU's
remote-DMA kernels. Here the D shards of a distributed pencil are held by one
process on one card in the stacked view: X is (D * Lb, m), shard d its rows
[d * Lb, (d + 1) * Lb). A shard's left halo is the previous shard's last Hb
rows, its right halo the next shard's first Hb rows; the chain ends get
zeros, written, not left as the buffer held them.

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

import functools
import math

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
             pad_rows: int = 0) -> torch.Tensor:
    """The plain transport (the reference's ppermute exchange): window and
    assemble. Not counted: it is a transport of its own, not only the ring
    shift's plain version."""
    _shards(X, D, Hb)
    return assemble(X, D, *window(X, D, Hb), own, pad_rows)


def ring_shift_ref(X: torch.Tensor, D: int, Hb: int, own: bool = False,
                   pad_rows: int = 0) -> torch.Tensor:
    """Plain version of ring_shift: the plain transport."""
    ring_shift_ref.calls += 1
    return ppermute(X, D, Hb, own, pad_rows)


def union_interior_overlap_ref(A: BELLUnion, X: torch.Tensor, D: int,
                               Hb: int, streams: str = "a"):
    """Plain version of union_interior_overlap: the plain union product of
    each stream, then the plain ring shift."""
    union_interior_overlap_ref.calls += 1
    return (*_union_ref(A, X, streams, "highest"), ppermute(X, D, Hb))


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
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def ring_shift(X: torch.Tensor, D: int, Hb: int, own: bool = False,
               pad_rows: int = 0) -> torch.Tensor:
    """Every shard's halo section of the stacked X (D * Lb, m), f32 or f64,
    in one launch: per shard [own rows if own | left Hb | right Hb |
    pad_rows zeros], stacked, (D * rows, m)."""
    if X.device.type == "cpu":
        return ring_shift_ref(X, D, Hb, own, pad_rows)
    Lb = _shards(X, D, Hb)
    if X.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ring_shift takes f32 or f64, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    rows = (Lb if own else 0) + 2 * Hb + pad_rows
    out = torch.empty((D * rows, X.shape[1]), dtype=X.dtype, device=X.device)
    row_bytes = X.shape[1] * X.element_size()
    unit = copy_unit(ring_shift_plan(D, Lb, Hb, own, pad_rows, row_bytes)[0],
                     X, out)
    _launch("ring_shift", X, X.data_ptr(), out.data_ptr(), D, Lb, Hb,
            row_bytes, pad_rows, int(own), unit)
    ring_shift.launches += 1
    return out


def union_interior_overlap(A: BELLUnion, X: torch.Tensor, D: int, Hb: int,
                           streams: str = "a"):
    """(Y_s for each stream s of `streams`, halo): A the stacked interior
    layout of the D shards (columns index the stacked X), X (D * Lb, m) f32;
    halo the (D * 2Hb, m) [left | right] section (ring_shift without own
    rows), written by copy blocks of the same launch."""
    if X.device.type == "cpu":
        return union_interior_overlap_ref(A, X, D, Hb, streams)
    Lb = _shards(X, D, Hb)
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
    halo = torch.empty((D * 2 * Hb, m), dtype=torch.float32, device=X.device)
    vb = pairs[1][0].data_ptr() if len(pairs) == 2 else None
    yb = Ys[1].data_ptr() if len(Ys) == 2 else None
    unit = copy_unit(ring_shift_plan(D, Lb, Hb, False, 0, m * 4)[0], X, halo)
    _launch("union_overlap_f32", X, pairs[0][0].data_ptr(), vb,
            *_tables(A), X.data_ptr(), Ys[0].data_ptr(), yb, halo.data_ptr(),
            A.n_tiles, m, A.cl, A.b, A.live.x_max, D, Lb, Hb, unit)
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
