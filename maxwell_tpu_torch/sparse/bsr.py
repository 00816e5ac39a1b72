"""Blocked-ELL ("tiled BSR") storage as torch tensors, and the plain
blocked SpMM that serves `kernel="ref"` (f64 solves, and any run whose
tensors are not on a CUDA device at f32), as in maxwell_tpu/sparse/bsr.py.

Each block-row stores a FIXED number S of b x b blocks (padding slots point
at block-column 0 with zero values), so the apply is one gather plus one
batched contraction. The logical dimension n is zero-padded to n_padded;
padded rows/cols are zero, so zero-padded vectors stay zero-padded under
the apply — the solvers rely on that invariant instead of masking.

`from_csr` also builds the reference's per-tile window metadata
(win_start, cols_rel, win_unit), which the windowed kernel
(kernels/bsr_spmm.py) reads, and a per-block-row slot count that lets the
CUDA kernels skip a row's trailing padding slots; `kernel_metadata=False`
(the "ref" pencils) skips both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _window_metadata(blocks_np: np.ndarray, cols_np: np.ndarray, b: int):
    """Per-tile aligned X-window metadata for the windowed kernel (a copy
    of maxwell_tpu/sparse/bsr.py:_window_metadata).

    Tile = R block rows (R*b = 128). win_unit W_u = the max per-tile column
    span; window starts are aligned DOWN to W_u so the kernel reads two
    adjacent (W_u*b)-row panels of X. Narrow windows require a
    bandwidth-reduced ordering (sparse/reorder.py).
    Returns (win_start (n_tiles,), cols_rel (nbr, S), W_u) or (None, None, 0).
    """
    R = max(128 // b, 1)
    nbr, S = cols_np.shape
    if nbr % R != 0 or nbr == 0:
        return None, None, 0
    n_tiles = nbr // R
    nz = np.abs(blocks_np).max(axis=(2, 3)) > 0  # (nbr, S)
    cols_t = cols_np.reshape(n_tiles, R * S)
    nz_t = nz.reshape(n_tiles, R * S)
    big = np.where(nz_t, cols_t, np.iinfo(np.int32).max)
    small = np.where(nz_t, cols_t, -1)
    cmin = np.minimum(big.min(axis=1), nbr - 1)  # empty tiles -> clamp
    cmax = small.max(axis=1)
    span = np.maximum(cmax - cmin + 1, 1)
    W_u = int(span.max())
    aligned = (cmin // W_u).astype(np.int32)  # in W_u units
    # relative columns; padding (zero) blocks clamp to 0
    aligned_per_row = np.repeat(aligned, R)  # (nbr,)
    rel = cols_np - aligned_per_row[:, None] * W_u
    rel = np.where(nz, rel, 0).astype(np.int32)
    if rel.min() < 0 or (rel[nz] >= 2 * W_u).any():
        return None, None, 0
    return aligned, rel, W_u


def _slot_count(blocks_np: np.ndarray) -> np.ndarray:
    """(nbr,) int32: 1 + the last slot of each block row that holds a
    nonzero value (0 for an empty row). Slots past it are padding, whatever
    order the builder stored a row's blocks in."""
    nz = np.abs(blocks_np).max(axis=(2, 3)) > 0
    S = nz.shape[1]
    last = S - np.argmax(nz[:, ::-1], axis=1)
    return np.where(nz.any(axis=1), last, 0).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """blocks: (n_brows, S, b, b); cols: (n_brows, S) int32 block-column
    per slot (0 for padding); n: logical square dimension.

    win_start: (n_tiles,) int32 aligned window index of each R-block-row
    tile; cols_rel: (n_brows, S) int32 columns relative to win_start*win_unit
    (0 for padding); win_unit: the window unit in block rows (0 when no
    window metadata was built). slot_count: (n_brows,) int32 slots per row
    up to its last nonzero block."""

    blocks: torch.Tensor
    cols: torch.Tensor
    n: int
    win_start: torch.Tensor | None = None
    cols_rel: torch.Tensor | None = None
    win_unit: int = 0
    slot_count: torch.Tensor | None = None

    @property
    def b(self) -> int:
        return self.blocks.shape[-1]

    @property
    def n_brows(self) -> int:
        return self.blocks.shape[0]

    @property
    def slots(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_padded(self) -> int:
        return self.n_brows * self.b

    @property
    def nnz_dense(self) -> int:
        """Stored (dense-block) entry count, padding slots included."""
        return self.blocks.numel()

    @staticmethod
    def _from_numpy(blocks, cols, n, ws, rel, wu, dtype, device, counts):
        t = lambda a: None if a is None else torch.from_numpy(
            np.array(a, dtype=np.int32)).to(device)
        return BSRMatrix(
            blocks=torch.as_tensor(blocks, dtype=dtype, device=device),
            cols=t(cols), n=int(n), win_start=t(ws), cols_rel=t(rel),
            win_unit=int(wu),
            slot_count=t(_slot_count(blocks)) if counts else None,
        )

    @staticmethod
    def from_csr(
        A: sp.spmatrix,
        block: int = 8,
        align_slots: int | None = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
        row_align: int | None = None,
        kernel_metadata: bool = True,
    ) -> "BSRMatrix":
        """Convert a square scipy sparse matrix to blocked-ELL (same padding
        rules as the reference: the block-row count rounds up to a multiple
        of row_align, default one 128-row tile; S to a multiple of
        align_slots, default 128 // b). kernel_metadata: build the window
        metadata and slot counts the CUDA kernels read (the plain apply
        reads neither)."""
        A = sp.csr_matrix(A)
        n = A.shape[0]
        if A.shape[0] != A.shape[1]:
            raise ValueError("square matrices only")
        b = block
        if row_align is None:
            row_align = max(128 // b, 1)
        n_brows = _round_up(_round_up(max(n, 1), b) // b, row_align)
        n_pad = n_brows * b
        if align_slots is None:
            align_slots = max(128 // b, 1)

        A_pad = sp.csr_matrix((A.data, A.indices, A.indptr), shape=(n, n))
        A_pad.resize((n_pad, n_pad))
        Ab = A_pad.tobsr(blocksize=(b, b))
        Ab.sort_indices()
        per_row = np.diff(Ab.indptr)
        S = int(per_row.max()) if per_row.size else 1
        S = max(_round_up(max(S, 1), align_slots), align_slots)

        row = np.repeat(np.arange(n_brows), per_row)
        slot = np.arange(Ab.indices.size) - Ab.indptr[row]
        blocks = np.zeros((n_brows, S, b, b), dtype=np.float64)
        cols = np.zeros((n_brows, S), dtype=np.int32)
        blocks[row, slot] = Ab.data
        cols[row, slot] = Ab.indices
        ws, rel, wu = (
            _window_metadata(blocks, cols, b) if kernel_metadata
            else (None, None, 0)
        )
        return BSRMatrix._from_numpy(blocks, cols, n, ws, rel, wu, dtype,
                                     device, kernel_metadata)

    @staticmethod
    def from_reference(obj, device: str | torch.device = "cuda") -> "BSRMatrix":
        """Carry a layout over from the JAX package (its BSRMatrix, or any
        object with the same fields): blocks, cols, n and the window
        metadata, each read through np.asarray; slot_count is derived."""
        blocks = np.array(obj.blocks)  # a writable copy
        ws = getattr(obj, "win_start", None)
        rel = getattr(obj, "cols_rel", None)
        return BSRMatrix._from_numpy(
            blocks, np.asarray(obj.cols), obj.n,
            None if ws is None else np.asarray(ws),
            None if rel is None else np.asarray(rel),
            getattr(obj, "win_unit", 0),
            torch.from_numpy(blocks[:0]).dtype, device, True,
        )

    def to_csr(self) -> sp.csr_matrix:
        """Round-trip back to scipy CSR (testing)."""
        b, S, nbr = self.b, self.slots, self.n_brows
        A = sp.bsr_matrix(
            (
                self.blocks.cpu().numpy().reshape(-1, b, b),
                self.cols.cpu().numpy().ravel(),
                np.arange(nbr + 1) * S,
            ),
            shape=(self.n_padded, self.n_padded),
        ).tocsr()
        A.eliminate_zeros()
        return A[: self.n, : self.n].tocsr()

    # --- vector packing ---------------------------------------------------
    def pad_vec(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-pad a logical (n,) or (n, m) tensor to n_padded rows."""
        pad = self.n_padded - self.n
        if pad == 0:
            return x
        widths = [0, 0] * (x.dim() - 1) + [0, pad]
        return torch.nn.functional.pad(x, widths)

    def unpad_vec(self, x: torch.Tensor) -> torch.Tensor:
        return x[: self.n]


def bsr_matmat_ref(A: BSRMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for X of shape (n_padded, m) (or taller: cols index X's
    block rows). Gather X block-rows per slot, then one einsum."""
    b = A.b
    Xg = X.reshape(-1, b, X.shape[-1])[A.cols]  # (nbr, S, b, m)
    Y = torch.einsum("rsij,rsjm->rim", A.blocks, Xg)
    return Y.reshape(A.n_padded, -1)


def bsr_matvec_ref(A: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for x of shape (n_padded,)."""
    return bsr_matmat_ref(A, x[:, None])[:, 0]
