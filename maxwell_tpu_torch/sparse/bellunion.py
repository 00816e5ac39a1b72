"""Tile-union blocked sparse layout ("BELLUnion") as torch tensors — the
layout the CUDA SpMM kernels (kernels/spmm.py, csrc/bellunion_spmm.cu) read.

Layout (identical to maxwell_tpu/sparse/bellunion.py, so the two packages can
be held against each other): per 128-row tile, the union of its
block-columns is grouped into aligned runs of `pack` block-columns and cut
into chunks of cl lanes (cl // b block-columns). Chunks of all tiles are
stored consecutively in one flat (NC * 128, cl) value array:

    vals[128k + r, c]   row r of tile tile_of[k], lane c of chunk k
    ucols[k, j]         block-column of lane group j (padding groups repeat
                        a valid column and carry zero values)
    tile_of[k]          owning tile; the chunks of one tile are consecutive
    first[k]            1 on a tile's first chunk
    tile_ptr[t]         first chunk of tile t (n_tiles + 1 entries; derived
                        from tile_of, read by the CUDA kernels, which walk a
                        tile's chunks inside one thread block)
    tile_end[t]         optional: one past the last LIVE chunk of tile t,
                        where zero chunks pad the layout (`pad_chunks`); the
                        kernels stop there (None: tile_ptr[t + 1])

The layout stores about 53x the CSR values of the 24^3 curl-curl operator
as zero fill: the TPU traded that for (128, 1024) dots shaped for its
matrix unit. Its fields stay as the reference has them (the plain versions
and the tests read them); beside them every layout carries `live`, a
LiveBlocks: the 8-row x 16-lane sub-blocks that hold a nonzero (20% of the
stored ones at 16^3 and 24^3), their values compacted one sub-block after
another, and the X runs each chunk needs. The CUDA kernels read only that.
It is derived once, when the layout is made (from_csr, from_reference),
and carried through to, bf16x3, pad_chunks, banded and the distributed
stack.

`pad_chunks` appends zero chunks (the distributed partitioner pads every
shard's layout to one chunk count and stacks them). `banded` splits the
layout into row bands, each reading one contiguous X window: the reference
needed that where X overflowed VMEM; a CUDA kernel reads X from global
memory at any size, so the banded apply (kernels/spmm.py) is an entry point
off the solve path. The reference's host buffer arena (first-touch page
faults on the TPU host) is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


# every value tensor of a layout: the f32 streams and their bf16 splits
_VALUE_STREAMS = ("vals", "vals_b", "vals_h", "vals_l", "vals_b_h", "vals_b_l")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _tensor(v, device):
    """np.asarray of any array-like leaf as a torch tensor on `device`.
    bfloat16 numpy arrays (ml_dtypes, as the JAX package holds them) are
    carried over bit for bit through an int16 view."""
    if v is None:
        return None
    a = np.asarray(v)
    if a.dtype.itemsize == 2 and a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16
        ).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _tile_ptr(tile_of: np.ndarray, n_tiles: int) -> np.ndarray:
    counts = np.bincount(tile_of, minlength=n_tiles)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _ptr(counts: torch.Tensor) -> torch.Tensor:
    """int32 prefix offsets [0, c0, c0 + c1, ...] of a count vector."""
    return torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)


def _bf16_split(v):
    """hi = bf16_rn(v), lo = bf16_rn(v - f32(hi)), elementwise."""
    if v is None:
        return None, None
    vh = v.to(torch.bfloat16)
    return vh, (v - vh.to(v.dtype)).to(torch.bfloat16)


# sub-block shape of the live form: one 8-row group of a tile by one run of
# 16 lanes (the k16 of a bf16 mma.sync), 16 row groups per 128-row tile
SB_ROWS, SB_LANES = 8, 16
ROW_GROUPS = 128 // SB_ROWS


@dataclasses.dataclass(frozen=True)
class LiveBlocks:
    """The live sub-blocks of a BELLUnion layout, which the CUDA kernels
    read instead of the full value streams.

    Sub-block (k, r, s) is rows 8r .. 8r + 7 of chunk k (row group r of its
    tile) by lanes 16s .. 16s + 15 (run s; at the default b = 8, pack = 2
    one aligned run of 16 X rows). It is live if any value stream of the
    layout holds a nonzero in it, so one list serves every stream:

        sb_ptr[16k + r] .. sb_ptr[16k + r + 1]
                    the live sub-blocks of row group r of chunk k, in run
                    order; sub-block i's values are row i of each stream
        sb_run[i]   the position of sub-block i's run in its chunk's run
                    list (xr_run[xr_ptr[k] + sb_run[i]] is the run)
        xr_ptr[k] .. xr_ptr[k + 1]
                    the runs live in some row group of chunk k, ascending:
                    the X rows the kernel stages for that chunk
        xr_run[j]   a run index within its chunk
        x_max       the most live runs of one chunk (sizes the staging)

    vals, vals_b, vals_h, vals_l, vals_b_h, vals_b_l: the matching full
    streams of the layout, compacted to (NSB, 8, 16): sub-block i's rows
    and lanes, row-major. Row-major is the order of the mma fragments
    (csrc/bellunion_tile.cuh): lane t of a warp holds row t // 4, lanes
    4 (t % 4) .. + 3, one 16-byte (f32) or 8-byte (bf16) load. All index
    tensors are int32.
    """

    sb_ptr: torch.Tensor
    sb_run: torch.Tensor
    xr_ptr: torch.Tensor
    xr_run: torch.Tensor
    x_max: int
    vals: torch.Tensor | None = None
    vals_b: torch.Tensor | None = None
    vals_h: torch.Tensor | None = None
    vals_l: torch.Tensor | None = None
    vals_b_h: torch.Tensor | None = None
    vals_b_l: torch.Tensor | None = None

    _INDEX = ("sb_ptr", "sb_run", "xr_ptr", "xr_run")

    @property
    def n_blocks(self) -> int:
        return self.sb_run.shape[0]

    @property
    def n_runs(self) -> int:
        return self.xr_run.shape[0]

    @staticmethod
    def build(A: "BELLUnion") -> "LiveBlocks":
        """Find A's live sub-blocks from its f32 value streams (vals and
        vals_b; a bf16 split is zero wherever its f32 value is) and compact
        every value stream A carries, on A's device."""
        NC, R = A.n_chunks, A.cl // SB_LANES
        if A.cl % SB_LANES:
            raise ValueError(f"chunk width {A.cl} is not a multiple of 16")

        def blocks(v):  # (chunk, row group, row, run, lane) view
            return v.view(NC, ROW_GROUPS, SB_ROWS, R, SB_LANES)

        live = torch.zeros((NC, ROW_GROUPS, R), dtype=torch.bool,
                           device=A.vals.device)
        for v in (A.vals, A.vals_b):
            if v is not None:
                live |= (blocks(v) != 0).any(4).any(2)
        k, r, s = live.nonzero(as_tuple=True)  # in (chunk, group, run) order
        xlive = live.any(1)  # (NC, R): runs live in some row group
        n_x = xlive.sum(1)
        pos = xlive.cumsum(1) - 1  # run -> position in its chunk's list
        return LiveBlocks(
            sb_ptr=_ptr(live.sum(2).reshape(-1)),
            sb_run=pos[k, s].to(torch.int32),
            xr_ptr=_ptr(n_x),
            xr_run=xlive.nonzero(as_tuple=True)[1].to(torch.int32),
            x_max=int(n_x.max()) if NC else 0,
            **{f: blocks(getattr(A, f))[k, r, :, s, :].contiguous()
               for f in _VALUE_STREAMS if getattr(A, f) is not None},
        )

    def _streams(self) -> dict:
        return {f: getattr(self, f) for f in _VALUE_STREAMS}

    def to(self, device) -> "LiveBlocks":
        return dataclasses.replace(self, **{
            f: t.to(device) for f, t in
            {**{f: getattr(self, f) for f in self._INDEX},
             **self._streams()}.items() if t is not None})

    def bf16x3(self) -> "LiveBlocks":
        """The bf16 (hi, lo) split of the compacted f32 streams: the same
        elementwise rounding as BELLUnion.bf16x3, so bit for bit the
        compacted split of the full streams."""
        vh, vl = _bf16_split(self.vals)
        bh, bl = _bf16_split(self.vals_b)
        return dataclasses.replace(
            self, vals_h=vh, vals_l=vl, vals_b_h=bh, vals_b_l=bl)

    def pad(self, n_pad: int) -> "LiveBlocks":
        """n_pad more chunks with no live sub-block (pad_chunks)."""
        return dataclasses.replace(
            self,
            sb_ptr=torch.cat([self.sb_ptr,
                              self.sb_ptr[-1:].repeat(ROW_GROUPS * n_pad)]),
            xr_ptr=torch.cat([self.xr_ptr, self.xr_ptr[-1:].repeat(n_pad)]),
        )

    def chunks(self, k0: int, k1: int, streams) -> "LiveBlocks":
        """Chunks k0 .. k1 - 1 as a list of their own (a band): pointers
        rebased, the named value streams as views of this one's."""
        sb_ptr = self.sb_ptr[ROW_GROUPS * k0: ROW_GROUPS * k1 + 1]
        xr_ptr = self.xr_ptr[k0: k1 + 1]
        i0, i1 = int(sb_ptr[0]), int(sb_ptr[-1])
        j0, j1 = int(xr_ptr[0]), int(xr_ptr[-1])
        return LiveBlocks(
            sb_ptr=sb_ptr - i0, sb_run=self.sb_run[i0:i1],
            xr_ptr=xr_ptr - j0, xr_run=self.xr_run[j0:j1],
            x_max=int((xr_ptr[1:] - xr_ptr[:-1]).max()) if k1 > k0 else 0,
            **{f: getattr(self, f)[i0:i1] for f in streams
               if getattr(self, f) is not None},
        )

    @staticmethod
    def stack(lives, streams) -> "LiveBlocks":
        """One list of the chunks of several layouts, one after the other
        (the distributed stack), with the named value streams: run indices
        are chunk-local, so only the pointers move."""
        def cat_ptr(f):
            parts, off = [], 0
            for lv in lives:
                p = getattr(lv, f)
                parts.append(p[:-1] + off)
                off += int(p[-1])
            return torch.cat(parts + [parts[0].new_full((1,), off)])

        def cat(f):
            ts = [getattr(lv, f) for lv in lives]
            return None if ts[0] is None else torch.cat(ts)

        return LiveBlocks(
            sb_ptr=cat_ptr("sb_ptr"), sb_run=cat("sb_run"),
            xr_ptr=cat_ptr("xr_ptr"), xr_run=cat("xr_run"),
            x_max=max(lv.x_max for lv in lives),
            **{f: cat(f) for f in streams},
        )


@dataclasses.dataclass(frozen=True)
class BELLUnion:
    """Tile-union chunked sparse matrix (see module docstring).

    vals: (NC*128, cl) value stream a (K); vals_b: optional stream b (M) on
    the same structure. vals_h/vals_l (and vals_b_h/vals_b_l): optional
    bf16 (hi, lo) split of each stream for the "b3" kernels, built by
    bf16x3(). ucols (NC, cl // b), tile_of/first (NC,), tile_ptr
    (n_tiles + 1,), all int32.
    """

    vals: torch.Tensor
    ucols: torch.Tensor
    tile_of: torch.Tensor
    first: torch.Tensor
    tile_ptr: torch.Tensor
    n: int
    n_tiles: int
    b: int = 8
    cl: int = 1024
    vals_b: torch.Tensor | None = None
    n_cols: int | None = None
    pack: int = 1
    vals_h: torch.Tensor | None = None
    vals_l: torch.Tensor | None = None
    vals_b_h: torch.Tensor | None = None
    vals_b_l: torch.Tensor | None = None
    tile_end: torch.Tensor | None = None
    live: LiveBlocks | None = None

    # the reference's leaves (from_reference) and tile_ptr
    _TENSORS = (
        "vals", "ucols", "tile_of", "first", "tile_ptr", "vals_b",
        "vals_h", "vals_l", "vals_b_h", "vals_b_l",
    )

    @property
    def n_padded(self) -> int:
        return self.n_tiles * 128

    @property
    def n_cols_padded(self) -> int:
        """Rows the gathered-from X buffer must have."""
        if self.n_cols is None:
            return self.n_padded
        return _round_up(max(self.n_cols, 1), self.b * self.pack)

    @property
    def n_chunks(self) -> int:
        return self.tile_of.shape[0]

    @property
    def nnz_dense(self) -> int:
        """Stored (= streamed) entries of one value stream."""
        return self.vals.numel()

    def to(self, device) -> "BELLUnion":
        """Copy with every tensor moved to `device`."""
        return dataclasses.replace(
            self,
            **{
                f: getattr(self, f).to(device)
                for f in (*self._TENSORS, "tile_end", "live")
                if getattr(self, f) is not None
            },
        )

    def with_live(self) -> "BELLUnion":
        """Copy carrying the live form derived from the value streams."""
        return dataclasses.replace(self, live=LiveBlocks.build(self))

    def bf16x3(self) -> "BELLUnion":
        """Copy carrying the bf16 (hi, lo) split of each value stream:
        hi = bf16_rn(v), lo = bf16_rn(v - f32(hi)). f32(hi) + f32(lo) keeps
        ~16 mantissa bits of v, at the same bytes as one f32 stream. The
        live form gets the split of its compacted streams."""
        vh, vl = _bf16_split(self.vals)
        bh, bl = _bf16_split(self.vals_b)
        return dataclasses.replace(
            self, vals_h=vh, vals_l=vl, vals_b_h=bh, vals_b_l=bl,
            live=None if self.live is None else self.live.bf16x3(),
        )

    @staticmethod
    def from_reference(obj, device="cuda") -> "BELLUnion":
        """Carry a layout over from the JAX package (its BELLUnion,
        or any object with the same fields): each leaf is read through
        np.asarray, and tile_ptr is derived from tile_of."""
        tile_of = np.asarray(obj.tile_of).astype(np.int32)
        n_tiles = int(obj.n_tiles)
        leaves = {
            f: _tensor(getattr(obj, f, None), device)
            for f in BELLUnion._TENSORS
            if f != "tile_ptr"
        }
        return BELLUnion(
            **leaves,
            tile_ptr=torch.from_numpy(_tile_ptr(tile_of, n_tiles)).to(device),
            n=int(obj.n),
            n_tiles=n_tiles,
            b=int(obj.b),
            cl=int(obj.cl),
            n_cols=None if obj.n_cols is None else int(obj.n_cols),
            pack=int(obj.pack),
        ).with_live()

    # ------------------------------------------------------------------
    @staticmethod
    def from_csr(
        A: sp.spmatrix,
        block: int = 8,
        dtype: torch.dtype = torch.float32,
        B: sp.spmatrix | None = None,
        chunk_lanes: int = 1024,
        ncols: int | None = None,
        pack: int = 2,
        device: str | torch.device = "cuda",
    ) -> "BELLUnion":
        """Build from CSR on the host (the reference's vectorized build),
        then move the tensors to `device`. With B given, both value streams
        share the union sparsity structure. ncols: column-space size for
        rectangular matrices (None: square n_padded layout)."""
        b = block
        R = 128 // b
        cl = chunk_lanes
        CG = cl // b  # block-columns per chunk
        p = pack
        if CG % p != 0:
            raise ValueError(f"pack={p} must divide chunk block-cols {CG}")
        GP = CG // p  # pack groups per chunk
        A = sp.csr_matrix(A)
        if not A.has_canonical_format:
            # canonicalize a COPY: csr_matrix(A) shares data/indices with
            # the caller and sum_duplicates would mutate them in place
            A = A.copy()
            A.sum_duplicates()
        n = A.shape[0]
        n_pad = _round_up(max(n, 1), 128)
        rect = ncols is not None
        # the (pack*b)-row gather of the last group must stay inside X
        nc_pad = _round_up(max(ncols, 1), b * p) if rect else n_pad

        nbr = n_pad // b
        ncb = nc_pad // b
        ncbp = -(-ncb // p)  # pack groups across the column space
        n_tiles = nbr // R

        it = (
            np.int32
            if n_tiles * ncbp < 2**31 and nc_pad < 2**31
            else np.int64
        )

        def _skeys(C):
            """Per-scalar-nnz (tile, pack-group) composite keys and the
            scalar row index."""
            row = np.repeat(
                np.arange(C.shape[0], dtype=it), np.diff(C.indptr)
            )
            key = (row // 128) * it(ncbp) + C.indices.astype(it) // (b * p)
            return key, row

        kA, rowA = _skeys(A)
        if B is not None:
            Bc = sp.csr_matrix(B)
            if not Bc.has_canonical_format:
                Bc = Bc.copy()
                Bc.sum_duplicates()
            same_pattern = (
                A.indptr.shape == Bc.indptr.shape
                and np.array_equal(A.indptr, Bc.indptr)
                and np.array_equal(A.indices, Bc.indices)
            )
            if same_pattern:
                kB, rowB = kA, rowA
                uk = np.unique(kA)
            else:
                kB, rowB = _skeys(Bc)
                uk = np.union1d(np.unique(kA), np.unique(kB))
        else:
            Bc = None
            uk = np.unique(kA)

        # every tile needs >= 1 union group (zero-valued group 0 if empty)
        have = np.zeros(n_tiles, dtype=bool)
        have[(uk // ncbp)] = True
        if not have.all():
            synth = np.flatnonzero(~have).astype(it) * it(ncbp)
            uk = np.union1d(uk, synth)
        ut = uk // ncbp  # tile of each unique (tile, group)
        ug = (uk % ncbp).astype(np.int64)  # sorted unique groups per tile
        usize = np.bincount(ut, minlength=n_tiles)
        first_u = np.concatenate([[0], np.cumsum(usize)])

        nck = -(-usize // GP)  # chunks per tile
        NC = int(nck.sum())
        chunk0 = np.concatenate([[0], np.cumsum(nck)])

        # padded unions: every slot starts as the tile's LAST group, then
        # the live prefix is overwritten
        last_ug = ug[first_u[1:] - 1]
        gcols_flat = np.repeat(last_ug, nck * GP)
        pos_u = np.arange(uk.size) - first_u[ut]  # rank within tile union
        gcols_flat[chunk0[ut] * GP + pos_u] = ug
        # group g covers block-cols [g*p, g*p + p)
        ucols = (
            gcols_flat.reshape(NC, GP, 1) * p + np.arange(p)
        ).reshape(NC, CG).astype(np.int32)

        tile_of = np.repeat(np.arange(n_tiles, dtype=np.int32), nck)
        first = np.zeros(NC, dtype=np.int32)
        first[chunk0[:-1]] = 1

        np_dt = torch.empty((), dtype=dtype).numpy().dtype
        ft = np.int32 if NC * 128 * cl < 2**31 else np.int64
        chunk0_f = chunk0.astype(ft)
        first_uf = first_u.astype(ft)
        flat_cache: dict = {}

        def _fill(keys, row, C):
            """Scalar nnz (row, col) lands at chunk row chunk*128 + row%128,
            lane group*p*b + (blockcol%p)*b + col%b."""
            v = np.zeros((NC * 128, cl), np_dt)
            flat = flat_cache.get(id(keys))
            if flat is None:
                tile = keys // ncbp
                pos = np.searchsorted(uk, keys).astype(ft) - first_uf[tile]
                lane = (pos % GP) * ft(p * b) + (
                    (C.indices.astype(ft) // b) % p
                ) * ft(b) + C.indices.astype(ft) % b
                flat = (
                    (chunk0_f[tile] + pos // GP) * ft(128)
                    + row.astype(ft) % 128
                ) * ft(cl) + lane
                flat_cache[id(keys)] = flat
            v.reshape(-1)[flat] = C.data.astype(np_dt, copy=False)
            return torch.from_numpy(v).to(device)

        return BELLUnion(
            vals=_fill(kA, rowA, A),
            ucols=torch.from_numpy(ucols).to(device),
            tile_of=torch.from_numpy(tile_of).to(device),
            first=torch.from_numpy(first).to(device),
            tile_ptr=torch.from_numpy(_tile_ptr(tile_of, n_tiles)).to(device),
            vals_b=None if Bc is None else _fill(kB, rowB, Bc),
            n=n,
            n_tiles=n_tiles,
            b=b,
            cl=cl,
            n_cols=ncols,
            pack=p,
        ).with_live()

    def pad_chunks(self, NC: int) -> "BELLUnion":
        """Pad the chunk list to NC chunks, as the reference does
        (maxwell_tpu/sparse/bellunion.py:522): padding chunks carry zero
        values (in every value stream, bf16 splits included), point at the
        LAST tile with first = 0 and column 0, so the kernels, which walk
        each tile's chunks tile_ptr[t] .. tile_ptr[t + 1], would accumulate
        exact zeros there; tile_ptr is derived again. tile_end keeps each
        tile's live end, so the CUDA kernels skip the padding: the TPU grid
        streamed it, here it would all fall to the last tile's block. The
        padding chunks have no live sub-block."""
        cur = self.n_chunks
        if cur == NC:
            return self
        if cur > NC:
            raise ValueError(f"cannot shrink {cur} chunks to {NC}")
        pad = NC - cur
        CG = self.cl // self.b

        def padv(v):
            if v is None:
                return None
            out = v.new_zeros((NC * 128, self.cl))
            out[: cur * 128] = v
            return out

        tile_of = torch.cat([
            self.tile_of, self.tile_of.new_full((pad,), self.n_tiles - 1)])
        return dataclasses.replace(
            self,
            **{f: padv(getattr(self, f)) for f in _VALUE_STREAMS},
            ucols=torch.cat([self.ucols, self.ucols.new_zeros((pad, CG))]),
            tile_of=tile_of,
            first=torch.cat([self.first, self.first.new_zeros(pad)]),
            tile_ptr=torch.from_numpy(
                _tile_ptr(tile_of.cpu().numpy(), self.n_tiles)
            ).to(self.tile_ptr.device),
            tile_end=(self.tile_ptr[1:].clone() if self.tile_end is None
                      else self.tile_end),
            live=None if self.live is None else self.live.pad(pad),
        )

    def banded(self, m: int, budget_bytes: int = 10 * 1024 * 1024,
               split_bf16: bool = False) -> "BandedBELLUnion":
        """Split into row bands whose X windows hold at most
        budget_bytes // (4 m) rows (the reference's split,
        maxwell_tpu/sparse/bellunion.py:601). Under a bandwidth-reducing
        ordering consecutive tiles have overlapping column windows, so each
        band reads one CONTIGUOUS X slice [col_start, col_start + col_rows).

        A band's value streams are views of this layout's (contiguous chunk
        ranges); its ucols and tile_of are rebased to its window and first
        tile. Unlike the reference's band, whose column space is left square,
        a band is rectangular: its n_cols is its window's col_rows, which is
        what its kernel reads. split_bf16: give each band views of the
        bf16x3() split streams (the "b3" kernel's). Each band's live form
        is its chunks' part of this layout's, its streams views too."""
        if self.n_cols is not None:
            raise ValueError("banded() supports square layouts only")
        b = self.b
        tile_of = self.tile_of.cpu().numpy()
        ucols = self.ucols.cpu().numpy()
        cmin_t = np.full(self.n_tiles, np.iinfo(np.int64).max)
        cmax_t = np.zeros(self.n_tiles, dtype=np.int64)
        np.minimum.at(cmin_t, tile_of, ucols.min(axis=1))
        np.maximum.at(cmax_t, tile_of, ucols.max(axis=1) + 1)
        # a tile that no chunk names: a degenerate valid window
        unset = cmin_t > cmax_t
        cmin_t = np.where(unset, 0, cmin_t)
        cmax_t = np.where(unset, 1, cmax_t)
        max_rows = budget_bytes // (4 * m)
        full = self
        if split_bf16 and self.vals_h is None:
            full = self.bf16x3()
        chunk_of_tile0 = np.searchsorted(tile_of, np.arange(self.n_tiles))
        dev = self.ucols.device

        bands, starts, rows = [], [], []
        t0 = 0
        while t0 < self.n_tiles:
            t1 = t0 + 1
            c0, c1 = cmin_t[t0], cmax_t[t0]
            while t1 < self.n_tiles:
                nc0, nc1 = min(c0, cmin_t[t1]), max(c1, cmax_t[t1])
                if (nc1 - nc0) * b > max_rows:
                    break
                c0, c1, t1 = nc0, nc1, t1 + 1
            if (c1 - c0) * b > max_rows:
                raise ValueError(
                    "single tile window exceeds the X budget: reorder the "
                    "matrix (RCM) or raise budget_bytes"
                )
            k0 = int(chunk_of_tile0[t0])
            k1 = int(chunk_of_tile0[t1]) if t1 < self.n_tiles else self.n_chunks
            view = lambda v: None if v is None else v[k0 * 128 : k1 * 128]
            streams = {f: view(getattr(self, f))
                       for f in ("vals", "vals_b")}
            if split_bf16:
                streams.update({f: view(getattr(full, f))
                                for f in _VALUE_STREAMS[2:]})
            tof = tile_of[k0:k1] - t0
            bands.append(BELLUnion(
                **streams,
                ucols=torch.from_numpy(
                    (ucols[k0:k1] - c0).astype(np.int32)).to(dev),
                tile_of=torch.from_numpy(tof.astype(np.int32)).to(dev),
                first=self.first[k0:k1],
                tile_ptr=torch.from_numpy(_tile_ptr(tof, t1 - t0)).to(dev),
                tile_end=None if self.tile_end is None
                else self.tile_end[t0:t1] - k0,
                live=None if full.live is None
                else full.live.chunks(k0, k1, streams),
                n=(t1 - t0) * 128,
                n_tiles=t1 - t0,
                b=b,
                cl=self.cl,
                n_cols=int(c1 - c0) * b,
                pack=self.pack,
            ))
            starts.append(int(c0) * b)
            rows.append(int(c1 - c0) * b)
            t0 = t1
        return BandedBELLUnion(
            bands=tuple(bands), col_starts=tuple(starts),
            col_rows=tuple(rows), n=self.n, b=b,
        )

    def to_csr(self, stream: str = "a") -> sp.csr_matrix:
        """Round-trip for testing."""
        b = self.b
        vals = (self.vals if stream == "a" else self.vals_b).cpu().numpy()
        ucols = self.ucols.cpu().numpy()
        tile_of = self.tile_of.cpu().numpy()
        CG = self.cl // b
        rows, cols, blocks = [], [], []
        for k in range(self.n_chunks):
            vk = vals[128 * k : 128 * (k + 1)]
            for rl in range(128 // b):
                for g in range(CG):
                    blk = vk[rl * b : (rl + 1) * b, g * b : (g + 1) * b]
                    if np.any(blk != 0.0):
                        rows.append(tile_of[k] * (128 // b) + rl)
                        cols.append(ucols[k, g])
                        blocks.append(blk)
        nc = self.n if self.n_cols is None else self.n_cols
        if not rows:
            return sp.csr_matrix((self.n, nc))
        coo_r = np.repeat(
            np.asarray(rows) * b, b * b
        ) + np.tile(np.repeat(np.arange(b), b), len(rows))
        coo_c = np.repeat(
            np.asarray(cols) * b, b * b
        ) + np.tile(np.tile(np.arange(b), b), len(rows))
        out = sp.coo_matrix(
            (np.asarray(blocks).ravel(), (coo_r, coo_c)),
            shape=(self.n_padded, self.n_cols_padded),
        ).tocsr()
        return out[: self.n, :nc].tocsr()


@dataclasses.dataclass(frozen=True)
class BandedBELLUnion:
    """Row-band split of a BELLUnion (BELLUnion.banded): band i computes
    rows [sum of the earlier bands' n_padded, + bands[i].n_padded) of A @ X
    from the X rows [col_starts[i], col_starts[i] + col_rows[i])."""

    bands: tuple
    col_starts: tuple
    col_rows: tuple
    n: int
    b: int

    @property
    def n_padded(self) -> int:
        return sum(bp.n_padded for bp in self.bands)

    @property
    def nnz_dense(self) -> int:
        return sum(bp.nnz_dense for bp in self.bands)
