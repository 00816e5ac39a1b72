"""Blocked-ELL ("tiled BSR") storage as torch tensors, and the plain
blocked SpMM that serves `kernel="ref"` (f64 solves, and any run whose
tensors are not on a CUDA device at f32), as in maxwell_tpu/sparse/bsr.py.

Each block-row stores a FIXED number S of b x b blocks (padding slots point
at block-column 0 with zero values), so the apply is one gather plus one
batched contraction. The logical dimension n is zero-padded to n_padded;
padded rows/cols are zero, so zero-padded vectors stay zero-padded under
the apply — the solvers rely on that invariant instead of masking.

The reference's per-tile window metadata (win_start/cols_rel) serves only
its windowed Pallas kernels and is not built here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """blocks: (n_brows, S, b, b); cols: (n_brows, S) int64 block-column per
    slot (0 for padding); n: logical square dimension."""

    blocks: torch.Tensor
    cols: torch.Tensor
    n: int

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

    @staticmethod
    def from_csr(
        A: sp.spmatrix,
        block: int = 8,
        align_slots: int | None = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ) -> "BSRMatrix":
        """Convert a square scipy sparse matrix to blocked-ELL (same padding
        rules as the reference: n rounds up to whole 128-row tiles, S to a
        multiple of align_slots)."""
        A = sp.csr_matrix(A)
        n = A.shape[0]
        if A.shape[0] != A.shape[1]:
            raise ValueError("square matrices only")
        b = block
        # whole 128-row tiles, as the reference pads
        n_brows = _round_up(_round_up(max(n, 1), b) // b, max(128 // b, 1))
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
        cols = np.zeros((n_brows, S), dtype=np.int64)
        blocks[row, slot] = Ab.data
        cols[row, slot] = Ab.indices
        return BSRMatrix(
            blocks=torch.as_tensor(blocks, dtype=dtype, device=device),
            cols=torch.as_tensor(cols, device=device),
            n=n,
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
