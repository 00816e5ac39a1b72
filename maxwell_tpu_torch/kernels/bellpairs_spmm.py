"""BELLPairs SpMM entry points: the CUDA kernels' wrappers and their plain
PyTorch versions.

    bellpairs_matmat(A, X, stream)          Y = A @ X, one value stream
    bellpairs_km_matmat(A, X)               (K @ X, M @ X), X read once
    bellpairs_matmat_windowed(A, X)         Y = A @ X, X read through each
                                            128-row tile's aligned window
    bellpairs_matmat_banded(AB, X, stream)  Y = A @ X, one launch of the
                                            first per row band
    bellpairs_km_matmat_banded(AB, X)       (K @ X, M @ X) per row band

replace `bellpairs_matmat_pallas`, `bellpairs_km_matmat_pallas`,
`bellpairs_matmat_pallas_windowed`, `bellpairs_matmat_banded` and
`bellpairs_km_matmat_banded` of maxwell_tpu/kernels/spmm.py. The layout is
sparse/bellpairs.py's BELLPairs (or its BandedBELLPairs split) with 8x8
blocks; stream "a" is its first value stream (K), "b" its second (M).

A wrapper given CUDA tensors checks them and launches its kernel
(csrc/bellpairs_spmm.cu) or raises: f32 only, 8x8 blocks, whole 128-row
tiles, contiguous X with at least n_padded rows. Unlike the reference there
is no X size limit: the kernels read X from global memory. The banded forms
launch the SpMM kernels once per band, on a contiguous row slice (a view) of
X padded by max(col_rows) rows, writing into that band's rows of one
output. Given CPU tensors a wrapper runs its plain version (`*_ref`), which
the CPU tests hold against the JAX package and the chip smoke holds the
kernels against. Each wrapper counts its kernel launches in `.launches`
(a banded call counts once), each plain version its calls in `.calls`.
"""

from __future__ import annotations

import torch

from maxwell_tpu_torch.kernels.bsr_spmm import (  # noqa: F401 (re-exported)
    _launch,
    window_bytes,
    window_staged,
)
from maxwell_tpu_torch.sparse.bellpairs import BandedBELLPairs, BELLPairs


def _vals(A: BELLPairs, stream: str) -> torch.Tensor:
    if stream not in ("a", "b"):
        raise ValueError(f"unknown value stream {stream!r}")
    v = A.vals2d if stream == "a" else A.vals2d_b
    if v is None:
        raise ValueError(f"value stream {stream!r} not present")
    return v


def _need_window(A: BELLPairs) -> None:
    if A.win_start is None or A.cols_rel is None or A.win_unit <= 0:
        raise ValueError(
            "the windowed product needs window metadata: build the layout "
            "with BELLPairs.from_csr on a bandwidth-reduced ordering"
        )


def _window_pad(A: BELLPairs, X: torch.Tensor) -> torch.Tensor:
    """X zero-padded to whole (Wu*b)-row panels plus one spare panel, as
    maxwell_tpu/kernels/spmm.py:849-851 pads it."""
    panel = A.win_unit * A.b
    total = (-(-(X.shape[0] + A.b) // panel) + 1) * panel
    return torch.nn.functional.pad(X, (0, 0, 0, total - X.shape[0]))


def _band_slices(AB: BandedBELLPairs, X: torch.Tensor):
    """(band, its X slice, its first output row) of each band: the slices
    are views of X zero-padded by max(col_rows) rows."""
    Xp = torch.nn.functional.pad(X, (0, 0, 0, max(AB.col_rows)))
    row = 0
    for bp, cs, rows in zip(AB.bands, AB.col_starts, AB.col_rows):
        yield bp, Xp[cs : cs + rows], row
        row += bp.n_padded


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _gather(A: BELLPairs, X: torch.Tensor, cols: torch.Tensor):
    """(nbr, Q, 2b, m): the 2b consecutive X rows from 8*cols[r, q] that
    pair slot q of block row r multiplies (padding slots too)."""
    k = torch.arange(2 * A.b, device=X.device)
    return X[cols.long()[..., None] * A.b + k]


def _contract(A: BELLPairs, vals: torch.Tensor, Xg: torch.Tensor):
    nbr, Q = A.cols.shape
    V = vals.reshape(nbr, A.b, Q, 2 * A.b)
    return torch.einsum("riqk,rqkm->rim", V, Xg).reshape(nbr * A.b, -1)


def _pairs(A: BELLPairs, X: torch.Tensor, stream: str) -> torch.Tensor:
    return _contract(A, _vals(A, stream), _gather(A, X, A.cols))


def _pairs_km(A: BELLPairs, X: torch.Tensor):
    vb = _vals(A, "b")
    Xg = _gather(A, X, A.cols)
    return _contract(A, A.vals2d, Xg), _contract(A, vb, Xg)


def bellpairs_matmat_ref(A: BELLPairs, X: torch.Tensor, stream: str = "a"):
    """Plain version of bellpairs_matmat: one gather of every slot's X
    panel, one einsum."""
    bellpairs_matmat_ref.calls += 1
    return _pairs(A, X, stream)


def bellpairs_km_matmat_ref(A: BELLPairs, X: torch.Tensor):
    """Plain version of bellpairs_km_matmat: one gather, two einsums."""
    bellpairs_km_matmat_ref.calls += 1
    return _pairs_km(A, X)


def bellpairs_matmat_windowed_ref(A: BELLPairs, X: torch.Tensor):
    """Plain version of bellpairs_matmat_windowed: slot q of block row r
    reads block row win_start[r // R] * Wu + cols_rel[r, q] of the padded
    X, the tile's window, as the windowed kernel does (R = 128 // b)."""
    bellpairs_matmat_windowed_ref.calls += 1
    _need_window(A)
    R = 128 // A.b
    start = (A.win_start.long() * A.win_unit).repeat_interleave(R)
    Xg = _gather(A, _window_pad(A, X), start[:, None] + A.cols_rel.long())
    return _contract(A, A.vals2d, Xg)


def bellpairs_matmat_banded_ref(AB: BandedBELLPairs, X: torch.Tensor,
                                stream: str = "a"):
    """Plain version of bellpairs_matmat_banded: the plain product of each
    band on its X slice, concatenated."""
    bellpairs_matmat_banded_ref.calls += 1
    return torch.cat([_pairs(bp, xw, stream)
                      for bp, xw, _ in _band_slices(AB, X)])


def bellpairs_km_matmat_banded_ref(AB: BandedBELLPairs, X: torch.Tensor):
    """Plain version of bellpairs_km_matmat_banded."""
    bellpairs_km_matmat_banded_ref.calls += 1
    outs = [_pairs_km(bp, xw) for bp, xw, _ in _band_slices(AB, X)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(A: BELLPairs, X: torch.Tensor, x_rows: int, vals, index):
    if X.dtype != torch.float32 or any(v.dtype != torch.float32 for v in vals):
        raise ValueError(
            f"the BELLPairs kernels take f32, got X {X.dtype}, values "
            f"{[v.dtype for v in vals]}"
        )
    if A.b != 8:
        raise ValueError(f"the BELLPairs kernels take 8x8 blocks, got b={A.b}")
    if A.n_brows % (128 // A.b):
        raise ValueError(f"{A.n_brows} block rows are not whole 128-row tiles")
    if X.dim() != 2 or X.shape[1] < 1:
        raise ValueError(f"X must be (rows, m >= 1), got {tuple(X.shape)}")
    if X.shape[0] < x_rows:
        raise ValueError(f"X has {X.shape[0]} rows, need {x_rows}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    for t in (*vals, A.npairs, *index):
        if t.device != X.device:
            raise ValueError(f"layout on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError("layout tensors must be contiguous")
    for t in (A.npairs, *index):
        if t.dtype != torch.int32:
            raise ValueError(f"index tensors must be int32, got {t.dtype}")
    if any(v.data_ptr() % 16 for v in vals):
        raise ValueError("value streams must be 16-byte aligned")


def _out(rows: int, X: torch.Tensor) -> torch.Tensor:
    return torch.empty((rows, X.shape[1]), dtype=torch.float32,
                       device=X.device)


def _launch_pairs(A, vals, X, Y, x_rows):
    _check_cuda(A, X, x_rows, (vals,), (A.cols,))
    _launch("bellpairs_matmat_f32", X, vals.data_ptr(), A.cols.data_ptr(),
            A.npairs.data_ptr(), X.data_ptr(), Y.data_ptr(), A.n_brows,
            A.slots, X.shape[1])


def _launch_pairs_km(A, X, Yk, Ym, x_rows):
    vals = (A.vals2d, _vals(A, "b"))
    _check_cuda(A, X, x_rows, vals, (A.cols,))
    _launch("bellpairs_km_matmat_f32", X, vals[0].data_ptr(),
            vals[1].data_ptr(), A.cols.data_ptr(), A.npairs.data_ptr(),
            X.data_ptr(), Yk.data_ptr(), Ym.data_ptr(), A.n_brows, A.slots,
            X.shape[1])


def bellpairs_matmat(A: BELLPairs, X: torch.Tensor, stream: str = "a"):
    """Y = A @ X for stream "a" or "b", X (rows >= n_padded, m); Y
    (n_padded, m). m = 1 is a true m = 1 launch."""
    if X.device.type == "cpu":
        return bellpairs_matmat_ref(A, X, stream)
    Y = _out(A.n_padded, X)
    _launch_pairs(A, _vals(A, stream), X, Y, A.n_padded)
    bellpairs_matmat.launches += 1
    return Y


def bellpairs_km_matmat(A: BELLPairs, X: torch.Tensor):
    """(K @ X, M @ X) for a layout carrying both value streams."""
    if X.device.type == "cpu":
        return bellpairs_km_matmat_ref(A, X)
    Yk, Ym = _out(A.n_padded, X), _out(A.n_padded, X)
    _launch_pairs_km(A, X, Yk, Ym, A.n_padded)
    bellpairs_km_matmat.launches += 1
    return Yk, Ym


def bellpairs_matmat_windowed(A: BELLPairs, X: torch.Tensor):
    """Y = A @ X (stream a) through per-tile windows of X, zero-padded as
    the reference pads it; the window is staged in shared memory where
    `window_staged(A, m)`, else read from global memory."""
    if X.device.type == "cpu":
        return bellpairs_matmat_windowed_ref(A, X)
    _need_window(A)
    _check_cuda(A, X, A.n_padded, (A.vals2d,), (A.cols_rel, A.win_start))
    Xp = _window_pad(A, X)
    Y = _out(A.n_padded, X)
    m = X.shape[1]
    _launch("bellpairs_matmat_windowed_f32", X, A.vals2d.data_ptr(),
            A.cols_rel.data_ptr(), A.win_start.data_ptr(),
            A.npairs.data_ptr(), Xp.data_ptr(), Y.data_ptr(), A.n_brows,
            A.slots, m, A.win_unit, int(window_staged(A, m)))
    bellpairs_matmat_windowed.launches += 1
    return Y


def _check_banded(AB: BandedBELLPairs, X: torch.Tensor) -> None:
    if X.dim() != 2 or X.shape[0] < AB.n_padded:
        raise ValueError(
            f"X must be (rows >= {AB.n_padded}, m), got {tuple(X.shape)}"
        )


def bellpairs_matmat_banded(AB: BandedBELLPairs, X: torch.Tensor,
                            stream: str = "a"):
    """Y = A @ X for a BandedBELLPairs: the SpMM kernel once per band on
    its contiguous X slice, into the band's rows of Y."""
    if X.device.type == "cpu":
        return bellpairs_matmat_banded_ref(AB, X, stream)
    _check_banded(AB, X)
    Y = _out(AB.n_padded, X)
    for bp, xw, row in _band_slices(AB, X):
        _launch_pairs(bp, _vals(bp, stream), xw, Y[row : row + bp.n_padded],
                      xw.shape[0])
    bellpairs_matmat_banded.launches += 1
    return Y


def bellpairs_km_matmat_banded(AB: BandedBELLPairs, X: torch.Tensor):
    """(K @ X, M @ X) for a BandedBELLPairs carrying both value streams:
    the fused kernel once per band."""
    if X.device.type == "cpu":
        return bellpairs_km_matmat_banded_ref(AB, X)
    _check_banded(AB, X)
    Yk, Ym = _out(AB.n_padded, X), _out(AB.n_padded, X)
    for bp, xw, row in _band_slices(AB, X):
        rows = slice(row, row + bp.n_padded)
        _launch_pairs_km(bp, xw, Yk[rows], Ym[rows], xw.shape[0])
    bellpairs_km_matmat_banded.launches += 1
    return Yk, Ym


KERNELS = (bellpairs_matmat, bellpairs_km_matmat, bellpairs_matmat_windowed,
           bellpairs_matmat_banded, bellpairs_km_matmat_banded)
PLAIN = (bellpairs_matmat_ref, bellpairs_km_matmat_ref,
         bellpairs_matmat_windowed_ref, bellpairs_matmat_banded_ref,
         bellpairs_km_matmat_banded_ref)


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
