"""Level-scheduled sparse triangular solves on the device, as in
maxwell_tpu/kernels/tri_solve.py: the shift-invert operator's factored
solve (solvers/shift_invert.py).

Forward and backward substitution have sequential row dependencies. Level
scheduling groups the rows into dependency levels (a row's level is one
more than the highest level of the columns it references), and the rows of
one level solve in parallel. A factor is stored per level in padded ELL
form, built once on the host from a scipy CSR factor (`LevelSchedule`, the
reference's arrays, plus each row slot's live count and each level's live
rows), and as the kernel's compact plan: the rows renumbered in solve order
(position p is the p-th row solved), each live slot once with its
dependency as a position, and the window W, the largest distance in solve
order between a row and a position it reads.

    level_solve(S, B)        X = T^-1 B for one factor, (n,) or (n, m)
    level_solve_plain(S, B)  its plain PyTorch version: the reference's loop
                             body (tri_solve.py:149-157) as a Python loop
                             over the levels, with the ghost row n
    level_chain(n, device)   the hand-off floor probe: n positions handed
                             on through the kernel's tags, no loads

`level_solve` given CUDA tensors checks them and launches the hand kernel
(csrc/tri_solve.cu: every row in one launch, f32 or f64, x's window in
shared memory where its ring fits, else in device memory; `S.route(dtype)`)
or raises; given CPU tensors it runs the plain version. The wrapper counts
its launches in `.launches`, the plain version its calls in `.calls`.

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

# csrc/tri_solve.cu's compile-time shape, the plan's route and tail
# (tests/test_torch_tri_solve.py holds them to the source)
WARPS = 16  # rows in flight a block, one a warp (kWarps)
TAIL = 15  # the tail: the slots within TAIL positions of a row (kTail)
SMEM_MAX = 232_448  # shared memory a block may use (kSmemMax)


def stage_bytes(dtype: torch.dtype) -> int:
    """Shared memory of the kernel's tail stage: two buffers a warp of
    TAIL slots (value and position)."""
    return 2 * WARPS * TAIL * (torch.finfo(dtype).bits // 8 + 4)


@dataclasses.dataclass(frozen=True)
class LevelSchedule:
    """One triangular factor, level-scheduled with uniform level padding
    (the reference's layout, maxwell_tpu/kernels/tri_solve.py:29), and the
    kernel's compact plan in solve order.

    rows: (nL, Rmax) int32, the rows solved per level; padding = n (the
      ghost row), after the level's live rows.
    cols: (nL, Rmax, Smax) int32, dependency columns; padding = n, after
      the row's live slots.
    vals: (nL, Rmax, Smax), off-diagonal values (padding 0).
    diag: (n,), diagonal entries (ones for unit-triangular factors).
    cnt: (nL, Rmax) int32, the live slots of each row slot (0 on padding).
    live: (nL,) int32, the live rows of each level.
    dinv: (n + 1,), 1 / diag and 1 for the ghost row.

    The plan (position p: the p-th row solved, level by level, a level's
    rows in the order of `rows`):
    order: (n,) int32, the row at each position.
    pdinv: (n,), 1 / diag in solve order.
    ptr: (n + 1,) int32, each position's first slot in dep / dval.
    dep: (nnz,) int32, each live slot's dependency as a position, ascending
      within a row (the newest last).
    dval: (nnz,), its value.
    tail: (n,) int32, the first slot of each row's tail, the slots whose
      dependency is within TAIL positions of the row (at most TAIL).
    window: the largest p - dep over all slots (0 without slots).
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
    order: torch.Tensor
    pdinv: torch.Tensor
    ptr: torch.Tensor
    dep: torch.Tensor
    dval: torch.Tensor
    tail: torch.Tensor
    window: int

    @property
    def n_levels(self) -> int:
        return self.rows.shape[0]

    def ring(self, dtype: torch.dtype) -> int:
        """Entries of x's ring in shared memory for a solve in dtype: the
        smallest power of two >= window + WARPS (the window and the rows in
        flight; the kernel needs window + TAIL + 1), or 0 where
        its x and tags and the tail stage take more than SMEM_MAX bytes
        (the global route)."""
        ring = 1 << (self.window + WARPS - 1).bit_length()
        nbytes = ring * (torch.finfo(dtype).bits // 8 + 4)
        return ring if nbytes + stage_bytes(dtype) <= SMEM_MAX else 0

    def route(self, dtype: torch.dtype) -> str:
        """"shared" (x's window in shared memory) or "global"."""
        return "shared" if self.ring(dtype) else "global"

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

        # the plan: positions in solve order, each row's slots by the
        # position they read
        pos = np.empty(n, dtype=np.int64)
        pos[order_rows] = np.arange(n)
        e_p, e_d = pos[e_row], pos[e_col]
        srt = np.lexsort((e_d, e_p))
        e_p, e_d = e_p[srt], e_d[srt]
        ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(e_p, minlength=n), out=ptr[1:])
        if ptr[-1] > np.iinfo(np.int32).max:
            raise ValueError(f"{ptr[-1]} off-diagonal entries: the plan's "
                             f"int32 slot offsets hold at most 2^31 - 1")
        # each position's first slot within TAIL positions of it
        tail = ptr[1:] - np.bincount(e_p[e_d >= e_p - TAIL], minlength=n)

        def dev(a, dt=None):
            return torch.as_tensor(a, dtype=dt, device=device)

        diag_t = dev(diag, dtype)
        dinv = 1.0 / diag_t
        return LevelSchedule(
            rows=dev(rows_a), cols=dev(cols_a), vals=dev(vals_a, dtype),
            diag=diag_t, n=n, lower=lower, cnt=dev(cnt_a),
            live=dev(lvl_count[:n_levels].astype(np.int32)),
            dinv=torch.cat([dinv, diag_t.new_ones(1)]),
            order=dev(order_rows.astype(np.int32)),
            pdinv=dinv[dev(order_rows)],
            ptr=dev(ptr.astype(np.int32)),
            dep=dev(e_d.astype(np.int32)), dval=dev(e_val[srt], dtype),
            tail=dev(tail.astype(np.int32)),
            window=int((e_p - e_d).max()) if len(e_p) else 0,
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
    if S.dval.dtype != B.dtype or S.pdinv.dtype != B.dtype:
        raise ValueError(f"factor in {S.dval.dtype}, B in {B.dtype}")
    if B.dim() != 2 or B.shape[0] != S.n:
        raise ValueError(f"B must be ({S.n}, m), got {tuple(B.shape)}")
    plan = (S.order, S.ptr, S.tail, S.dep, S.dval, S.pdinv)
    for t in plan:
        if t.device != B.device:
            raise ValueError(f"factor on {t.device}, B on {B.device}")
        if not t.is_contiguous():
            raise ValueError("factor tensors must be contiguous")
    if any(t.dtype != torch.int32 for t in plan[:4]):
        raise ValueError("factor index tensors must be int32")


def level_solve(S: LevelSchedule, B: torch.Tensor) -> torch.Tensor:
    """X = T^-1 B for the factor S: B (n,) or (n, m). On a CUDA tensor one
    launch of the hand kernel walks every row (f32 or f64), with x's
    window in shared memory or, where its ring does not fit, in a scratch
    of (m, n) values and tags in device memory; on a CPU tensor the plain
    version."""
    from maxwell_tpu_torch.kernels.bsr_spmm import _launch

    vec = B.dim() == 1
    B = B[:, None] if vec else B
    if B.device.type == "cpu":
        X = level_solve_plain(S, B)
        return X[:, 0] if vec else X
    B = B.contiguous()
    _check_cuda(S, B)
    X = torch.empty_like(B)
    m = B.shape[1]
    ring = S.ring(B.dtype)
    xs = tags = None
    if not ring:
        xs = B.new_empty((m, S.n))
        tags = torch.empty((m, S.n), dtype=torch.int32, device=B.device)
    name = ("level_solve_f32" if B.dtype == torch.float32
            else "level_solve_f64")
    _launch(name, B, S.order.data_ptr(), S.ptr.data_ptr(),
            S.tail.data_ptr(), S.dep.data_ptr(), S.dval.data_ptr(),
            S.pdinv.data_ptr(), B.data_ptr(), X.data_ptr(),
            0 if xs is None else xs.data_ptr(),
            0 if tags is None else tags.data_ptr(), S.n, ring, m)
    level_solve.launches += 1
    return X[:, 0] if vec else X


CHAIN_RING = 512  # level_chain's ring: the 128^2 chains' shared ring


def level_chain(n: int, device, warps: int = WARPS) -> torch.Tensor:
    """The tag hand-off floor probe (csrc/tri_solve.cu level_chain_kernel):
    n positions taken in turn by `warps` warps (the solve's WARPS by
    default), each waiting on the one before it through the solve's tags
    in shared memory, reading its value and publishing it plus one, with
    no load from device memory. Returns a one-element f32 tensor that
    holds n once the launch has run. Needs the card; not counted."""
    from maxwell_tpu_torch.kernels.bsr_spmm import _launch

    out = torch.zeros(1, dtype=torch.float32, device=device)
    if out.device.type != "cuda":
        raise ValueError("level_chain is a probe of the card's kernel")
    _launch("level_chain_f32", out, out.data_ptr(), n, CHAIN_RING, warps)
    return out


def launch_shape(dtype: torch.dtype, route: str) -> dict:
    """The solve kernel's build for dtype and route on the current card:
    registers and local bytes a thread."""
    import ctypes

    from maxwell_tpu_torch.kernels import _build

    out = (ctypes.c_int64 * 2)()
    rc = _build.load().level_solve_shape(torch.finfo(dtype).bits // 8,
                                         int(route == "shared"),
                                         ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"level_solve_shape: CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1]}


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
