"""Level-scheduled sparse triangular solves on the device, as in
maxwell_tpu/kernels/tri_solve.py: the shift-invert operator's factored
solve (solvers/shift_invert.py).

Forward and backward substitution have sequential row dependencies. Level
scheduling groups the rows into dependency levels (a row's level is one
more than the highest level of the columns it references), and the rows of
one level solve in parallel. A factor is stored per level in padded ELL
form, built once on the host from a scipy CSR factor (`LevelSchedule`, the
reference's arrays, plus each row slot's live count and each level's live
rows).

    level_solve(S, B)        X = T^-1 B for one factor, (n,) or (n, m)
    level_solve_plain(S, B)  its plain PyTorch version: the reference's loop
                             body (tri_solve.py:149-157) as a Python loop
                             over the levels, with the ghost row n

`level_solve` given CUDA tensors checks them and launches the hand kernel
(csrc/tri_solve.cu: every level in one launch, f32 or f64) or raises; given
CPU tensors it runs the plain version. The wrapper counts its launches in
`.launches`, the plain version its calls in `.calls`.

`SparseLUDevice` (from scipy's splu) and `SparseLDLTDevice` (the native
LDL^T after an RCM ordering, maxwell_tpu_torch/native) solve with two
factors each; their permutation gathers and the D^-1 scale are plain
torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


@dataclasses.dataclass(frozen=True)
class LevelSchedule:
    """One triangular factor, level-scheduled with uniform level padding
    (the reference's layout, maxwell_tpu/kernels/tri_solve.py:29).

    rows: (nL, Rmax) int32, the rows solved per level; padding = n (the
      ghost row), after the level's live rows.
    cols: (nL, Rmax, Smax) int32, dependency columns; padding = n, after
      the row's live slots.
    vals: (nL, Rmax, Smax), off-diagonal values (padding 0).
    diag: (n,), diagonal entries (ones for unit-triangular factors).
    cnt: (nL, Rmax) int32, the live slots of each row slot (0 on padding).
    live: (nL,) int32, the live rows of each level.
    dinv: (n + 1,), 1 / diag and 1 for the ghost row.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    diag: torch.Tensor
    n: int
    lower: bool
    cnt: torch.Tensor
    live: torch.Tensor
    dinv: torch.Tensor

    @property
    def n_levels(self) -> int:
        return self.rows.shape[0]

    @staticmethod
    def from_csr(T: sp.spmatrix, lower: bool,
                 dtype: torch.dtype = torch.float64,
                 device: str | torch.device = "cuda") -> "LevelSchedule":
        """Build the level schedule of a triangular scipy matrix: the levels
        from the native `level_schedule_levels`, the packing vectorized
        numpy (maxwell_tpu/kernels/tri_solve.py:63-135)."""
        from maxwell_tpu_torch import native

        T = sp.csr_matrix(T)
        T.sort_indices()
        n = T.shape[0]
        indptr, indices, data = T.indptr, T.indices, T.data

        diag = np.ones(n, dtype=T.dtype)
        dvals = T.diagonal()
        diag[dvals != 0] = dvals[dvals != 0]

        level, _ = native.level_schedule_levels(indptr, indices, n, lower)

        # off-diagonal entries, grouped per row
        entry_row = np.repeat(np.arange(n), np.diff(indptr))
        off = indices < entry_row if lower else indices > entry_row
        e_row = entry_row[off]
        e_col = indices[off].astype(np.int32)
        e_val = data[off]
        row_nnz = np.bincount(e_row, minlength=n)
        # position of each entry within its row
        row_first = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(row_nnz, out=row_first[1:])
        e_pos = np.arange(len(e_row)) - row_first[e_row]

        n_levels = int(level.max()) + 1 if n else 0
        lvl_count = np.bincount(level, minlength=max(n_levels, 1))
        Rmax = int(lvl_count.max()) if n else 1
        Smax = max(int(row_nnz.max()) if n else 0, 1)

        # row's position within its level: stable argsort by level
        order_rows = np.argsort(level, kind="stable")
        pos_in_level = np.empty(n, dtype=np.int64)
        lvl_start = np.zeros(n_levels + 1, dtype=np.int64)
        np.cumsum(lvl_count, out=lvl_start[1:])
        pos_in_level[order_rows] = np.arange(n) - lvl_start[level[order_rows]]

        rows_a = np.full((n_levels, Rmax), n, dtype=np.int32)
        cnt_a = np.zeros((n_levels, Rmax), dtype=np.int32)
        cols_a = np.full((n_levels, Rmax, Smax), n, dtype=np.int32)
        vals_a = np.zeros((n_levels, Rmax, Smax), dtype=T.dtype)
        rows_a[level, pos_in_level] = np.arange(n, dtype=np.int32)
        cnt_a[level, pos_in_level] = row_nnz
        cols_a[level[e_row], pos_in_level[e_row], e_pos] = e_col
        vals_a[level[e_row], pos_in_level[e_row], e_pos] = e_val

        def dev(a, dt=None):
            return torch.as_tensor(a, dtype=dt, device=device)

        diag_t = dev(diag, dtype)
        return LevelSchedule(
            rows=dev(rows_a), cols=dev(cols_a), vals=dev(vals_a, dtype),
            diag=diag_t, n=n, lower=lower, cnt=dev(cnt_a),
            live=dev(lvl_count[:n_levels].astype(np.int32)),
            dinv=torch.cat([1.0 / diag_t, diag_t.new_ones(1)]),
        )

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = T^-1 b, (n,) or (n, m)."""
        return level_solve(self, b)


# ---------------------------------------------------------------------------
# The solve and its plain version
# ---------------------------------------------------------------------------


def level_solve_plain(S: LevelSchedule, B: torch.Tensor) -> torch.Tensor:
    """Plain version of level_solve, B (n, m): the reference's fori_loop
    body, one Python iteration a level. The ghost row n reads 0 and absorbs
    the padding rows' writes."""
    level_solve_plain.calls += 1
    m = B.shape[1]
    Xe = B.new_zeros((S.n + 1, m))
    Be = torch.cat([B, B.new_zeros((1, m))])
    dinv = S.dinv[:, None]
    for lv in range(S.n_levels):
        rws = S.rows[lv]
        acc = torch.einsum("rs,rsm->rm", S.vals[lv], Xe[S.cols[lv]])
        Xe[rws] = (Be[rws] - acc) * dinv[rws]
    return Xe[: S.n]


def _check_cuda(S: LevelSchedule, B: torch.Tensor) -> None:
    if B.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"level_solve takes f32 or f64, got {B.dtype}")
    if S.vals.dtype != B.dtype or S.dinv.dtype != B.dtype:
        raise ValueError(f"factor in {S.vals.dtype}, B in {B.dtype}")
    if B.dim() != 2 or B.shape[0] != S.n:
        raise ValueError(f"B must be ({S.n}, m), got {tuple(B.shape)}")
    for t in (S.rows, S.cnt, S.live, S.cols, S.vals, S.dinv):
        if t.device != B.device:
            raise ValueError(f"factor on {t.device}, B on {B.device}")
        if not t.is_contiguous():
            raise ValueError("factor tensors must be contiguous")
    if any(t.dtype != torch.int32 for t in (S.rows, S.cnt, S.live, S.cols)):
        raise ValueError("factor index tensors must be int32")


def level_solve(S: LevelSchedule, B: torch.Tensor) -> torch.Tensor:
    """X = T^-1 B for the factor S: B (n,) or (n, m). On a CUDA tensor one
    launch of the hand kernel walks every level (f32 or f64); on a CPU
    tensor the plain version."""
    vec = B.dim() == 1
    Bm = B[:, None] if vec else B
    if Bm.device.type == "cpu":
        X = level_solve_plain(S, Bm)
        return X[:, 0] if vec else X
    Bm = Bm.contiguous()
    _check_cuda(S, Bm)
    X = torch.empty_like(Bm)
    from maxwell_tpu_torch.kernels.bsr_spmm import _launch

    name = ("level_solve_f32" if Bm.dtype == torch.float32
            else "level_solve_f64")
    _launch(name, Bm, S.rows.data_ptr(), S.cnt.data_ptr(),
            S.live.data_ptr(), S.cols.data_ptr(), S.vals.data_ptr(),
            S.dinv.data_ptr(), Bm.data_ptr(), X.data_ptr(), S.n_levels,
            S.rows.shape[1], S.cols.shape[2], Bm.shape[1])
    level_solve.launches += 1
    return X[:, 0] if vec else X


def backward_error(S: LevelSchedule, B: torch.Tensor,
                   X: torch.Tensor) -> float:
    """Componentwise backward error of X as a solution of T X = B, over
    the bound that substitution in X's precision meets: max over i of
    |B - T X|_i / (gamma_k (|T| |X| + |B|)_i), with k = Smax + 2 (a row's
    products, its subtraction and the multiply by 1/diag), gamma_k = k u /
    (1 - k u) and u the unit roundoff of X's dtype (Higham, Accuracy and
    Stability of Numerical Algorithms, 2nd ed., Thm. 8.5). It holds for
    any summation order. Computed in f64 with plain torch on X's device;
    that residual's own rounding adds at most the same bound at f64, so a
    solve that rounds as substitution may gives at most 2."""
    u = torch.finfo(X.dtype).eps / 2
    k = S.cols.shape[2] + 2
    gamma = k * u / (1 - k * u)
    vec = B.dim() == 1
    Bd = (B[:, None] if vec else B).double()
    Xd = (X[:, None] if vec else X).double()
    Xe = torch.cat([Xd, Xd.new_zeros((1, Xd.shape[1]))])
    vals = S.vals.double()[..., None]
    gath = Xe[S.cols]  # (nL, R, S, m); the ghost row reads 0
    TX = torch.zeros_like(Xe)
    aTX = torch.zeros_like(Xe)
    TX[S.rows] = (vals * gath).sum(2)
    aTX[S.rows] = (vals.abs() * gath.abs()).sum(2)
    diag = S.diag.double()[:, None]
    TX = TX[: S.n] + diag * Xd
    aTX = aTX[: S.n] + diag.abs() * Xd.abs()
    bound = gamma * (aTX + Bd.abs())
    ratio = (Bd - TX).abs() / torch.clamp(bound, min=torch.finfo(
        torch.float64).tiny)
    return ratio.max().item()


KERNELS = (level_solve,)
PLAIN = (level_solve_plain,)


def reset_counts() -> None:
    """Zero the kernel's launch count and the plain version's call
    count."""
    level_solve.launches = 0
    level_solve_plain.calls = 0


def counts() -> dict:
    """{name: launches} of the kernel and {name: calls} of the plain
    version."""
    return {"level_solve": level_solve.launches,
            "level_solve_plain": level_solve_plain.calls}


reset_counts()


# ---------------------------------------------------------------------------
# Factored solves
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseLUDevice:
    """Sparse LU on the device: x = Pc (U^-1 (L^-1 (Pr b))), from scipy's
    splu (the host's numeric factorization)."""

    L: LevelSchedule
    U: LevelSchedule
    perm_r: torch.Tensor  # the inverse row permutation (apply to b)
    perm_c: torch.Tensor  # the column permutation (apply to z)
    n: int

    @staticmethod
    def from_splu(lu, dtype: torch.dtype = torch.float64,
                  device: str | torch.device = "cuda") -> "SparseLUDevice":
        """lu: a scipy.sparse.linalg.SuperLU. scipy's Pr A Pc = L U with
        (Pr b)[perm_r[i]] = b[i], so y = b[inv_perm_r], and x = z[perm_c]
        (maxwell_tpu/kernels/tri_solve.py:186-199)."""
        n = lu.shape[0]
        inv_perm_r = np.empty(n, dtype=np.int64)
        inv_perm_r[lu.perm_r] = np.arange(n)
        return SparseLUDevice(
            L=LevelSchedule.from_csr(lu.L.tocsr(), True, dtype, device),
            U=LevelSchedule.from_csr(lu.U.tocsr(), False, dtype, device),
            perm_r=torch.as_tensor(inv_perm_r, device=device),
            perm_c=torch.as_tensor(lu.perm_c.astype(np.int64),
                                   device=device),
            n=n,
        )

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        vec = b.dim() == 1
        B = b[:, None] if vec else b
        Y = self.L.solve(B[self.perm_r])
        X = self.U.solve(Y)[self.perm_c]
        return X[:, 0] if vec else X


@dataclasses.dataclass(frozen=True)
class SparseLDLTDevice:
    """Sparse LDL^T on the device: x = P^T (L^-T (D^-1 (L^-1 (P b)))),
    factored by the native up-looking LDL^T after a fill-reducing symmetric
    permutation (reverse Cuthill-McKee by default)."""

    L: LevelSchedule  # unit lower
    Lt: LevelSchedule  # its transpose (unit upper)
    dinv: torch.Tensor
    perm: torch.Tensor  # x_perm[i] = x_orig[perm[i]]
    iperm: torch.Tensor
    n: int

    @staticmethod
    def factor(A: sp.spmatrix, perm: np.ndarray | None = None,
               dtype: torch.dtype = torch.float64,
               device: str | torch.device = "cuda") -> "SparseLDLTDevice":
        """Factor the symmetric A (full matrix). Raises ZeroDivisionError
        on a zero pivot."""
        from maxwell_tpu_torch import native

        A = sp.csr_matrix(A)
        n = A.shape[0]
        if perm is None:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        Ap = A[perm][:, perm].tocsc()
        Lp, Li, Lx, D = native.ldlt_factor(sp.triu(Ap).tocsc())
        L = sp.csc_matrix((Lx, Li, Lp), shape=(n, n)).tocsr()
        iperm = np.empty(n, dtype=np.int64)
        iperm[perm] = np.arange(n)
        return SparseLDLTDevice(
            L=LevelSchedule.from_csr(L, True, dtype, device),
            Lt=LevelSchedule.from_csr(L.T.tocsr(), False, dtype, device),
            dinv=torch.as_tensor(1.0 / D, dtype=dtype, device=device),
            perm=torch.as_tensor(perm.astype(np.int64), device=device),
            iperm=torch.as_tensor(iperm, device=device),
            n=n,
        )

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        vec = b.dim() == 1
        B = b[:, None] if vec else b
        Y = self.L.solve(B[self.perm])
        W = self.Lt.solve(Y * self.dinv[:, None])
        X = W[self.iperm]
        return X[:, 0] if vec else X
