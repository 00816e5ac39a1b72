"""Paired, per-tile-chunked blocked-ELL storage ("BELLPairs") as torch
tensors — the layout the BELLPairs CUDA kernels (kernels/bellpairs_spmm.py,
csrc/bellpairs_spmm.cu) read.

Layout (identical to maxwell_tpu/sparse/bellpairs.py, so the two packages
can be held against each other bit for bit):

1. PAIRS: most blocks of an RCM-ordered FEM operator sit in runs of
   consecutive block-columns, so each slot stores a (b, 2b) PAIR of adjacent
   blocks; one slot reads 2b consecutive rows of X. A singleton zero-pads
   the second half of its pair; a singleton in the last block column is
   stored as the second half of a pair starting one column earlier, so no
   slot reads past n_padded.
2. PER-TILE CHUNKS: pair slots are grouped into chunks of Cp; each 128-row
   tile has `nch` live chunks. The CUDA kernels stop each block row at its
   own live pair count `npairs` instead (a finer stop; the slots skipped
   hold zeros).

    vals2d[r*b + i, q*2b + k]   row i of block row r, column k of pair q
    cols[r, q]                  pair q's first block column (0 for padding)

With B given (the mass matrix), both value streams share one union pair
structure (vals2d = K, vals2d_b = M), so the fused kernel reads X once per
slot. `banded` is the reference's row-band split: on the TPU it kept X
windows inside VMEM; here each band is launched on a contiguous row slice
of X (kernels/bellpairs_spmm.py, K14), off the solve path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _tensor(v, device):
    """np.asarray of an array-like leaf as a torch tensor on `device`."""
    if v is None:
        return None
    return torch.from_numpy(np.array(np.asarray(v))).to(device)


def _check_reads(cols: np.ndarray, npairs: np.ndarray, x_blocks: int) -> None:
    """Every live slot reads 2 block rows of X from its pair column: raise
    unless all of them lie inside the first x_blocks block rows."""
    live = np.arange(cols.shape[1])[None, :] < npairs[:, None]
    c = cols[live]
    if c.size and (c.min() < 0 or c.max() + 2 > x_blocks):
        raise ValueError(
            f"a live pair slot reads block rows {int(c.min())}.."
            f"{int(c.max()) + 1} outside the {x_blocks} block rows of X"
        )


@dataclasses.dataclass(frozen=True)
class BandedBELLPairs:
    """Row-band split of a BELLPairs matrix: band k is a BELLPairs whose
    columns are rebased to its X slice X[col_starts[k] : col_starts[k] +
    col_rows[k]]. See BELLPairs.banded()."""

    bands: tuple
    col_starts: tuple[int, ...]
    col_rows: tuple[int, ...]
    n: int
    b: int

    @property
    def n_padded(self) -> int:
        return sum(bp.n_padded for bp in self.bands)

    @staticmethod
    def from_reference(obj, device="cuda") -> "BandedBELLPairs":
        """Carry a JAX BandedBELLPairs over (each band through
        BELLPairs.from_reference, the band metadata as ints)."""
        return BandedBELLPairs(
            bands=tuple(
                BELLPairs.from_reference(bp, device, x_blocks=rows // obj.b)
                for bp, rows in zip(obj.bands, obj.col_rows)
            ),
            col_starts=tuple(int(c) for c in obj.col_starts),
            col_rows=tuple(int(r) for r in obj.col_rows),
            n=int(obj.n),
            b=int(obj.b),
        )


@dataclasses.dataclass(frozen=True)
class BELLPairs:
    """Paired chunked blocked-ELL matrix (see module docstring).

    vals2d: (n_brows*b, Q*2b) value stream a (K); vals2d_b: optional stream
    b (M) on the same structure. cols: (n_brows, Q) int32 pair-start block
    column. nch: (n_tiles,) int32 live chunks per 128-row tile. npairs:
    (n_brows,) int32 live pair slots per block row. win_start (n_tiles,) /
    cols_rel (n_brows, Q) / win_unit: per-tile aligned X-window metadata of
    the windowed kernel (None / 0 where the windows do not fit the scheme).
    """

    vals2d: torch.Tensor
    cols: torch.Tensor
    nch: torch.Tensor
    npairs: torch.Tensor
    n: int
    b: int = 8
    Cp: int = 8
    vals2d_b: torch.Tensor | None = None
    win_start: torch.Tensor | None = None
    cols_rel: torch.Tensor | None = None
    win_unit: int = 0

    _TENSORS = ("vals2d", "cols", "nch", "npairs", "vals2d_b", "win_start",
                "cols_rel")

    @property
    def n_brows(self) -> int:
        return self.cols.shape[0]

    @property
    def n_padded(self) -> int:
        return self.n_brows * self.b

    @property
    def slots(self) -> int:
        """Pair slots stored per block row (Q = max_ch * Cp)."""
        return self.cols.shape[1]

    @property
    def max_ch(self) -> int:
        return self.cols.shape[1] // self.Cp

    @property
    def n_tiles(self) -> int:
        return self.nch.shape[0]

    @property
    def nnz_dense(self) -> int:
        """Stored dense entries of one value stream."""
        return self.vals2d.numel()

    @property
    def nnz_streamed(self) -> int:
        """Entries of one stream in the live chunks (the reference's
        per-tile chunk clamp)."""
        R = 128 // self.b
        return int(self.nch.sum()) * R * self.b * self.Cp * 2 * self.b

    def to(self, device) -> "BELLPairs":
        """Copy with every tensor moved to `device`."""
        return dataclasses.replace(
            self,
            **{
                f: getattr(self, f).to(device)
                for f in self._TENSORS
                if getattr(self, f) is not None
            },
        )

    @staticmethod
    def from_reference(obj, device="cuda", x_blocks=None) -> "BELLPairs":
        """Carry a JAX BELLPairs over: every leaf read through np.asarray.
        x_blocks: block rows of the X the layout is applied to (default
        n_brows; a band's X slice for a band)."""
        leaves = {f: _tensor(getattr(obj, f, None), device)
                  for f in BELLPairs._TENSORS}
        bp = BELLPairs(**leaves, n=int(obj.n), b=int(obj.b), Cp=int(obj.Cp),
                       win_unit=int(obj.win_unit))
        _check_reads(np.asarray(obj.cols), np.asarray(obj.npairs),
                     bp.n_brows if x_blocks is None else x_blocks)
        return bp

    # ------------------------------------------------------------------
    @staticmethod
    def from_csr(
        A: sp.spmatrix,
        block: int = 8,
        Cp: int = 8,
        dtype: torch.dtype = torch.float32,
        B: sp.spmatrix | None = None,
        device: str | torch.device = "cuda",
    ) -> "BELLPairs":
        """Build on the host exactly as the reference does
        (maxwell_tpu/sparse/bellpairs.py:142-277), then move to `device`.
        With B given (the mass matrix), both value streams share ONE union
        sparsity structure."""
        b = block
        R = 128 // b
        A = sp.csr_matrix(A)
        n = A.shape[0]
        n_pad = _round_up(max(n, 1), b * R)

        def _pad_bsr(C):
            Cp_ = sp.csr_matrix((C.data, C.indices, C.indptr), shape=C.shape)
            Cp_.resize((n_pad, n_pad))
            Cb = Cp_.tobsr(blocksize=(b, b))
            Cb.sort_indices()
            return Cb

        if B is not None:
            B = sp.csr_matrix(B)
            # sample both matrices at the UNION pattern's coordinates so the
            # two BSR conversions share identical (indptr, indices)
            U = ((A != 0) + (B != 0)).tocsr()
            U.sort_indices()
            Uc = U.tocoo()

            def _sample(C):
                return np.asarray(C[Uc.row, Uc.col]).ravel()

            Au = sp.csr_matrix(
                (_sample(A), U.indices.copy(), U.indptr.copy()), shape=A.shape
            )
            Bu = sp.csr_matrix(
                (_sample(B), U.indices.copy(), U.indptr.copy()), shape=A.shape
            )
            Ab, Bb = _pad_bsr(Au), _pad_bsr(Bu)
            assert np.array_equal(Ab.indices, Bb.indices)
            data_b = Bb.data
        else:
            Ab = _pad_bsr(A)
            data_b = None
        indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
        nbr = n_pad // b
        n_tiles = nbr // R

        # greedy pairing of the sorted block columns of each row: within a
        # run of consecutive block columns, pairs start at even offsets
        L = indices.size
        row_of = np.repeat(np.arange(nbr), np.diff(indptr))
        brk = np.ones(L, dtype=bool)
        if L > 1:
            brk[1:] = (indices[1:] != indices[:-1] + 1) | (
                row_of[1:] != row_of[:-1]
            )
        run_first_idx = np.nonzero(brk)[0]
        run_id = np.cumsum(brk) - 1
        off = np.arange(L) - run_first_idx[run_id]
        is_start = (off % 2) == 0
        has_next = np.zeros(L, dtype=bool)
        if L > 1:
            has_next[:-1] = run_id[1:] == run_id[:-1]
        is_pair = is_start & has_next

        kl = np.nonzero(is_start)[0]  # slot left-block data index
        s_row = row_of[kl]
        s_col = indices[kl].astype(np.int64)
        s_pair = is_pair[kl]
        npairs = np.bincount(s_row, minlength=nbr).astype(np.int32)
        slot_off = np.concatenate([[0], np.cumsum(npairs)])
        s_q = np.arange(kl.size) - slot_off[s_row]

        Pt = npairs.reshape(n_tiles, R).max(axis=1)
        nch = (-(-np.maximum(Pt, 1) // Cp)).astype(np.int32)
        max_ch = int(nch.max()) if n_tiles else 1
        Q = max_ch * Cp

        np_dt = torch.empty((), dtype=dtype).numpy().dtype
        vals = np.zeros((nbr, Q, b, 2 * b), dtype=np_dt)
        vals_b = None if data_b is None else np.zeros_like(vals)
        cols = np.zeros((nbr, Q), dtype=np.int32)
        # a singleton in the LAST block column becomes the second half of a
        # pair one column earlier, so its 2b-row X read stays in bounds
        clamp = (~s_pair) & (s_col + 1 >= nbr)
        cols[s_row, s_q] = np.where(clamp, s_col - 1, s_col).astype(np.int32)
        for v, d in [(vals, data)] + (
            [] if vals_b is None else [(vals_b, data_b)]
        ):
            nc = ~clamp
            v[s_row[nc], s_q[nc], :, :b] = d[kl[nc]]
            v[s_row[clamp], s_q[clamp], :, b:] = d[kl[clamp]]
            v[s_row[s_pair], s_q[s_pair], :, b:] = d[kl[s_pair] + 1]

        def _to2d(v):
            return np.ascontiguousarray(
                v.transpose(0, 2, 1, 3).reshape(nbr * b, Q * 2 * b)
            )

        # per-tile aligned X-window metadata (live slots only; +1 covers
        # the pair's second block column)
        live = np.arange(Q)[None, :] < npairs[:, None]
        big = np.where(live, cols, np.iinfo(np.int32).max)
        small = np.where(live, cols + 1, -1)
        cmin = np.minimum(
            big.reshape(n_tiles, R * Q).min(axis=1), max(nbr - 1, 0)
        )
        cmax = small.reshape(n_tiles, R * Q).max(axis=1)
        span = np.maximum(cmax - cmin + 1, 1)
        W_u = int(span.max())
        ws = (cmin // W_u).astype(np.int32)
        rel = cols - np.repeat(ws, R)[:, None] * W_u
        rel = np.where(live, rel, 0).astype(np.int32)
        ok = rel.min() >= 0 and not (rel[live] + 1 >= 2 * W_u).any()
        _check_reads(cols, npairs, nbr)

        t = lambda a: torch.from_numpy(a).to(device)
        return BELLPairs(
            vals2d=t(_to2d(vals)),
            cols=t(cols),
            nch=t(nch),
            npairs=t(npairs),
            n=n, b=b, Cp=Cp,
            vals2d_b=None if vals_b is None else t(_to2d(vals_b)),
            win_start=t(ws) if ok else None,
            cols_rel=t(rel) if ok else None,
            win_unit=W_u if ok else 0,
        )

    # ------------------------------------------------------------------
    def banded(self, m: int, budget_bytes: int = 10 * 1024 * 1024):
        """Split into row bands whose X windows hold at most
        budget_bytes // (4 m) rows (the reference's split,
        maxwell_tpu/sparse/bellpairs.py:280-357). Under a bandwidth-reducing
        ordering consecutive tiles have monotone, overlapping column
        windows, so each band reads one CONTIGUOUS X slice. A band's value
        streams, nch and npairs are views of this layout's; its columns are
        rebased to the slice."""
        b, R, Cp = self.b, 128 // self.b, self.Cp
        nbr, Q = self.cols.shape
        n_tiles = self.n_tiles
        cols = self.cols.cpu().numpy()
        npairs = self.npairs.cpu().numpy()

        # padding slots hold col 0 / zero values: mask them out of the
        # window computation (they would pin every window's min to 0)
        live = np.arange(Q)[None, :] < npairs[:, None]
        big = np.where(live, cols, np.iinfo(np.int32).max)
        small = np.where(live, cols, -1)
        cmin_t = np.minimum(big.reshape(n_tiles, R * Q).min(axis=1), nbr - 1)
        cmax_t = small.reshape(n_tiles, R * Q).max(axis=1) + 2  # pair spill
        # a tile with ZERO live slots would yield an inverted window: clamp
        # it to a degenerate valid window at the tile's own diagonal block
        empty = ~live.reshape(n_tiles, R * Q).any(axis=1)
        own = np.minimum(np.arange(n_tiles) * R, max(nbr - 2, 0))
        cmin_t = np.where(empty, own, cmin_t)
        cmax_t = np.where(empty, own + 2, cmax_t)
        max_rows = budget_bytes // (4 * m)

        bands, starts, rows = [], [], []
        t0 = 0
        while t0 < n_tiles:
            t1 = t0 + 1
            c0, c1 = cmin_t[t0], cmax_t[t0]
            while t1 < n_tiles:
                nc0, nc1 = min(c0, cmin_t[t1]), max(c1, cmax_t[t1])
                if (nc1 - nc0 + 1) * b > max_rows:
                    break
                c0, c1, t1 = nc0, nc1, t1 + 1
            if (c1 - c0 + 1) * b > max_rows:
                raise ValueError(
                    f"single tile window exceeds X budget ({m=}): reorder "
                    "the matrix (RCM) or raise budget_bytes"
                )
            r0, r1 = t0 * R, t1 * R
            sub_cols = np.maximum(cols[r0:r1] - c0, 0).astype(np.int32)
            _check_reads(sub_cols, npairs[r0:r1], int(c1 - c0 + 1))
            bands.append(BELLPairs(
                vals2d=self.vals2d[r0 * b : r1 * b],
                cols=torch.from_numpy(sub_cols).to(self.cols.device),
                nch=self.nch[t0:t1],
                npairs=self.npairs[r0:r1],
                n=(r1 - r0) * b,
                b=b,
                Cp=Cp,
                vals2d_b=None if self.vals2d_b is None
                else self.vals2d_b[r0 * b : r1 * b],
            ))
            starts.append(int(c0) * b)
            rows.append(int(c1 - c0 + 1) * b)
            t0 = t1
        return BandedBELLPairs(
            bands=tuple(bands), col_starts=tuple(starts),
            col_rows=tuple(rows), n=self.n, b=b,
        )

    def to_csr(self, stream: str = "a") -> sp.csr_matrix:
        """Round-trip back to scipy CSR (testing)."""
        b = self.b
        nbr, Q = self.cols.shape
        v = self.vals2d if stream == "a" else self.vals2d_b
        vals = v.cpu().numpy().reshape(nbr, b, Q, 2 * b).transpose(0, 2, 1, 3)
        cols = self.cols.cpu().numpy()
        # (nbr, Q, 2, b, b): the two blocks of every pair slot
        blk = vals.reshape(nbr, Q, b, 2, b).transpose(0, 1, 3, 2, 4)
        r, q, h = np.nonzero(np.any(blk != 0.0, axis=(3, 4)))
        if r.size == 0:
            return sp.csr_matrix((self.n, self.n))
        ii, jj = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
        rows = (r[:, None, None] * b + ii).ravel()
        cs = ((cols[r, q] + h)[:, None, None] * b + jj).ravel()
        out = sp.coo_matrix(
            (blk[r, q, h].ravel(), (rows, cs)),
            shape=(self.n_padded, self.n_padded),
        ).tocsr()
        out.eliminate_zeros()
        return out[: self.n, : self.n].tocsr()
