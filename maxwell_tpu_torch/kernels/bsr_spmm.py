"""Blocked-ELL SpMM entry points: the CUDA kernels' wrappers and their plain
PyTorch versions.

    bsr_matmat(A, X)            Y = A @ X, X resident in global memory
    bsr_matmat_windowed(A, X)   the same product, X read through each
                                128-row tile's aligned window
    bsr_matvec(A, x)            y = A @ x, m = 1

replace `bsr_matmat_pallas`, `bsr_matmat_pallas_windowed` and
`bsr_matvec_pallas` of maxwell_tpu/kernels/spmm.py. The layout is
sparse/bsr.py's BSRMatrix with 8x8 blocks, as `Pencil(kernel="pallas")`
builds it; the windowed form needs the window metadata `from_csr` builds.

A wrapper given CUDA tensors checks them and launches its kernel
(csrc/bsr_spmm.cu: one body for all three; f32 FMAs at m <= 2, 3xTF32
tensor-core products from m = 3) or raises: f32 only, 8x8 blocks, whole
128-row tiles.
Unlike the reference there is no fallback to the einsum path for f64, for
unaligned layouts or for a large X: the kernels read X from global memory
at any size. Given CPU tensors a wrapper runs its plain version (`*_ref`),
which the CPU tests hold against the JAX package and the chip smoke holds
the kernels against. Each wrapper counts its kernel launches in
`.launches`, each plain version its calls in `.calls`.
"""

from __future__ import annotations

import torch

from maxwell_tpu_torch.sparse import bsr as _bsr
from maxwell_tpu_torch.sparse.bsr import BSRMatrix

# a staged window must fit one block's shared memory (H100: 227 KB)
SMEM_LIMIT = 232448


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _window_pad(A: BSRMatrix, X: torch.Tensor) -> torch.Tensor:
    """X zero-padded to whole (Wu*b)-row panels plus one spare panel, so
    the second panel of the last tile's window stays in bounds (as
    maxwell_tpu/kernels/spmm.py:173-177)."""
    panel = A.win_unit * A.b
    total = (-(-X.shape[0] // panel) + 1) * panel
    return torch.nn.functional.pad(X, (0, 0, 0, total - X.shape[0]))


def bsr_matmat_ref(A: BSRMatrix, X: torch.Tensor) -> torch.Tensor:
    """Plain version of bsr_matmat (sparse/bsr.py's gather + einsum)."""
    bsr_matmat_ref.calls += 1
    return _bsr.bsr_matmat_ref(A, X)


def bsr_matmat_windowed_ref(A: BSRMatrix, X: torch.Tensor) -> torch.Tensor:
    """Plain version of bsr_matmat_windowed: slot s of block row r reads
    block row win_start[r // R] * Wu + cols_rel[r, s] of the padded X, the
    tile's window, as the windowed kernel does (R = 128 // b)."""
    bsr_matmat_windowed_ref.calls += 1
    _need_window(A)
    b, m = A.b, X.shape[1]
    R = max(128 // b, 1)
    Xb = _window_pad(A, X).reshape(-1, b, m)
    start = (A.win_start.long() * A.win_unit).repeat_interleave(R)
    Xg = Xb[start[:, None] + A.cols_rel.long()]  # (nbr, S, b, m)
    Y = torch.einsum("rsij,rsjm->rim", A.blocks, Xg)
    return Y.reshape(A.n_padded, m)


def bsr_matvec_ref(A: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain version of bsr_matvec."""
    bsr_matvec_ref.calls += 1
    return _bsr.bsr_matvec_ref(A, x)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _need_window(A: BSRMatrix) -> None:
    if A.win_start is None or A.cols_rel is None or A.win_unit <= 0:
        raise ValueError(
            "the windowed product needs window metadata: build the layout "
            "with BSRMatrix.from_csr on a bandwidth-reduced ordering"
        )


def window_bytes(A: BSRMatrix, m: int) -> int:
    """Bytes of one tile's X window (two Wu*b-row panels) at width m."""
    return 2 * A.win_unit * A.b * m * 4


def window_staged(A: BSRMatrix, m: int) -> bool:
    """Whether the windowed kernel stages the window in shared memory at
    width m (else it reads the window from global memory)."""
    return window_bytes(A, m) <= SMEM_LIMIT


def _check_cuda(A: BSRMatrix, X: torch.Tensor, layout) -> None:
    if X.dtype != torch.float32 or A.blocks.dtype != torch.float32:
        raise ValueError(
            f"the blocked-ELL kernels take f32, got X {X.dtype}, blocks "
            f"{A.blocks.dtype}"
        )
    if A.b != 8:
        raise ValueError(f"the blocked-ELL kernels take 8x8 blocks, got b={A.b}")
    if A.n_brows % (128 // A.b):
        raise ValueError(
            f"{A.n_brows} block rows are not whole 128-row tiles"
        )
    if X.dim() != 2 or X.shape[1] < 1:
        raise ValueError(f"X must be (rows, m >= 1), got {tuple(X.shape)}")
    if X.shape[0] < A.n_padded:
        raise ValueError(f"X has {X.shape[0]} rows, need {A.n_padded}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    if A.slot_count is None:
        raise ValueError("the layout has no slot_count (build it with "
                         "BSRMatrix.from_csr or from_reference)")
    for t in (A.blocks, A.slot_count, *layout):
        if t.device != X.device:
            raise ValueError(f"layout on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError("layout tensors must be contiguous")
    for t in (A.slot_count, *layout):
        if t.dtype != torch.int32:
            raise ValueError(f"index tensors must be int32, got {t.dtype}")
    if A.blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned")


def _launch(name: str, X: torch.Tensor, *args) -> None:
    from maxwell_tpu_torch.kernels import _build

    with torch.cuda.device(X.device):
        rc = getattr(_build.load(), name)(
            *args, torch.cuda.current_stream(X.device).cuda_stream
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _out(A: BSRMatrix, X: torch.Tensor) -> torch.Tensor:
    return torch.empty((A.n_padded, X.shape[1]), dtype=torch.float32,
                       device=X.device)


def bsr_matmat(A: BSRMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (rows >= n_padded, m); Y (n_padded, m)."""
    if X.device.type == "cpu":
        return bsr_matmat_ref(A, X)
    _check_cuda(A, X, (A.cols,))
    Y = _out(A, X)
    _launch("bsr_matmat_f32", X, A.blocks.data_ptr(), A.cols.data_ptr(),
            A.slot_count.data_ptr(), X.data_ptr(), Y.data_ptr(), A.n_brows,
            A.slots, X.shape[1])
    bsr_matmat.launches += 1
    return Y


def bsr_matmat_windowed(A: BSRMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X through per-tile windows of X (zero-padded as the
    reference pads it); the window is staged in shared memory where
    `window_staged(A, m)`, else read from global memory."""
    if X.device.type == "cpu":
        return bsr_matmat_windowed_ref(A, X)
    _need_window(A)
    _check_cuda(A, X, (A.cols_rel, A.win_start))
    Xp = _window_pad(A, X)
    Y = _out(A, X)
    m = X.shape[1]
    _launch("bsr_matmat_windowed_f32", X, A.blocks.data_ptr(),
            A.cols_rel.data_ptr(), A.win_start.data_ptr(),
            A.slot_count.data_ptr(), Xp.data_ptr(), Y.data_ptr(), A.n_brows,
            A.slots, m, A.win_unit, int(window_staged(A, m)))
    bsr_matmat_windowed.launches += 1
    return Y


def bsr_matvec(A: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a vector x (length >= n_padded); y (n_padded,). A
    true m = 1 launch of the SpMM kernel (the reference widened x to an
    8-lane panel)."""
    if x.dim() != 1:
        raise ValueError(f"x must be a vector, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return bsr_matvec_ref(A, x)
    X = x[:, None]
    _check_cuda(A, X, (A.cols,))
    y = torch.empty(A.n_padded, dtype=torch.float32, device=x.device)
    _launch("bsr_matmat_f32", X, A.blocks.data_ptr(), A.cols.data_ptr(),
            A.slot_count.data_ptr(), x.data_ptr(), y.data_ptr(), A.n_brows,
            A.slots, 1)
    bsr_matvec.launches += 1
    return y


KERNELS = (bsr_matmat, bsr_matmat_windowed, bsr_matvec)
PLAIN = (bsr_matmat_ref, bsr_matmat_windowed_ref, bsr_matvec_ref)


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
