"""Tile-union SpMM probes: the CUDA kernels' wrappers and their plain
PyTorch versions. No solver calls them; the probe scripts
(maxwell_tpu_torch/bench/exp_union.py, exp_union2.py) do.

K15a, the synthetic tile-union panel of maxwell_tpu/bench/exp_union.py.
Tile t (of T 128-row tiles) gathers the (K, 8) panel
panel[k] = X[idx[t, k // run] * 8 + k % run] and writes
Y[128t + r] = vals[128t + r] @ panel; Y has X's rows, those from 128 T on
zero (the reference's jnp.pad):

    u0_hi(cols, vals, X)           run 8 (the union's block columns), f32
    u0_def(cols, vals, X)          the same with bf16 operands (nearest
                                   even) and f32 sums: the TPU's DEFAULT
                                   precision, through mma.sync m16n8k16
    u1_runs(rcols, vals, X)        run 64 (UC / 8 runs of 8 block columns)
    u2_km(rcols, vals, vals_b, X)  run 64, one gather for two value
                                   streams: Y = Yk + Ym

cols (T, UC) and rcols (T, UC // 8) are int32 block-row starts, vals
(128 T, K = 8 UC) f32, X (rows >= 128 T, 8) f32; K at most MAX_K (two
tiles' panels in a block's shared memory). The kernels spread the rows
over the SMs in 16-row units on a persistent grid (`panel_launch_shape`).

K15b, union_unstaged(A, X) (maxwell_tpu/bench/exp_union2.py's "cat"
kernel): Y = A @ X on a BELLUnion layout, the same product as K2
(kernels/spmm.py::bellunion_matmat, "highest") on the same live form, in
K2's order of operations (so bit for bit equal to it), with the gathered X
rows read from global memory instead of a chunk's X runs staged in shared
memory. Any chunk width that is a multiple of 128, any pack, b a multiple
of 4, any m.

A wrapper given CUDA tensors checks them and launches its kernel
(csrc/union_probes.cu) or raises; given CPU tensors it runs the plain
version (`*_ref`). Each wrapper counts its launches in `.launches`, each
plain version its calls in `.calls`. `panel_plain` and `unstaged_plain`
are the plain arithmetic without a count: the probe scripts' oracles, whose
comparison launches do not count as the probe's path.
"""

from __future__ import annotations

import torch

from maxwell_tpu_torch.kernels import spmm
from maxwell_tpu_torch.kernels.bsr_spmm import _launch
from maxwell_tpu_torch.sparse.bellunion import BELLUnion

PANEL_WIDTH = 8  # the probe's b = m = 8
# a block of the panel kernels holds the panels of at least two tiles in
# the H100's 232,448 bytes of shared memory: f32 8 K floats each, bf16
# 8 (K + 16) values of 2 bytes
SMEM_LIMIT = 232448
MAX_K = {False: SMEM_LIMIT // (2 * 8 * 4),
         True: SMEM_LIMIT // (2 * 8 * 2) - 16}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def panel_rows(idx: torch.Tensor, run: int) -> torch.Tensor:
    """(T, K) X row of each panel row: idx[t, k // run] * 8 + k % run."""
    q = torch.arange(run, device=idx.device)
    return (idx.long()[:, :, None] * 8 + q).reshape(idx.shape[0], -1)


def panel_plain(idx, vals, X, run, bf16=False, vals_b=None):
    """Gather each tile's panel by index, one bmm per value stream against
    the (T, 128, K) value blocks (bf16: both operands rounded to bf16
    first, products summed in f32), rows from 128 T on zero."""
    T, K = idx.shape[0], vals.shape[1]
    P = X[panel_rows(idx, run)]  # (T, K, 8)
    streams = [vals] + ([] if vals_b is None else [vals_b])
    Y = 0
    for v in streams:
        V = v.view(T, 128, K)
        if bf16:
            Y = Y + torch.bmm(V.bfloat16().float(), P.bfloat16().float())
        else:
            Y = Y + torch.bmm(V, P)
    out = torch.zeros((X.shape[0], X.shape[1]), dtype=X.dtype,
                      device=X.device)
    out[: 128 * T] = Y.reshape(128 * T, -1)
    return out


def unstaged_plain(A: BELLUnion, X: torch.Tensor) -> torch.Tensor:
    """The union product of stream a, f32: K2's plain arithmetic."""
    return spmm._union_ref(A, X, "a", "highest")[0]


def u0_hi_ref(cols, vals, X):
    """Plain version of u0_hi."""
    u0_hi_ref.calls += 1
    return panel_plain(cols, vals, X, 8)


def u0_def_ref(cols, vals, X):
    """Plain version of u0_def."""
    u0_def_ref.calls += 1
    return panel_plain(cols, vals, X, 8, bf16=True)


def u1_runs_ref(rcols, vals, X):
    """Plain version of u1_runs."""
    u1_runs_ref.calls += 1
    return panel_plain(rcols, vals, X, 64)


def u2_km_ref(rcols, vals, vals_b, X):
    """Plain version of u2_km."""
    u2_km_ref.calls += 1
    return panel_plain(rcols, vals, X, 64, vals_b=vals_b)


def union_unstaged_ref(A: BELLUnion, X: torch.Tensor) -> torch.Tensor:
    """Plain version of union_unstaged."""
    union_unstaged_ref.calls += 1
    return unstaged_plain(A, X)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_panel(idx, vals, X, run, vals_b=None, bf16=False) -> None:
    if X.dtype != torch.float32 or any(
            v.dtype != torch.float32 for v in (vals, vals_b) if v is not None):
        raise ValueError("the panel kernels take f32 X and values, got "
                         f"{X.dtype} and {vals.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] < 1:
        raise ValueError(f"idx must be int32 (T >= 1, K / run), got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    T, K = idx.shape[0], idx.shape[1] * run
    if K % 16:
        raise ValueError(f"K = {K} must be a multiple of 16")
    if K > MAX_K[bf16]:
        raise ValueError(f"K = {K} > {MAX_K[bf16]}: two panels leave a "
                         "block's shared memory")
    for v in (vals, vals_b):
        if v is not None and tuple(v.shape) != (128 * T, K):
            raise ValueError(f"values must be ({128 * T}, {K}), got "
                             f"{tuple(v.shape)}")
    if X.dim() != 2 or X.shape[1] != PANEL_WIDTH or X.shape[0] < 128 * T:
        raise ValueError(f"X must be (rows >= {128 * T}, {PANEL_WIDTH}), "
                         f"got {tuple(X.shape)}")
    for t in (idx, vals, vals_b, X):
        if t is None:
            continue
        if t.device != X.device:
            raise ValueError(f"an operand on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t is not idx and t.data_ptr() % 16:
            raise ValueError("values and X must be 16-byte aligned")


def _panel_cuda(name, idx, vals, X, run, vals_b=None):
    from maxwell_tpu_torch.kernels import _build

    _check_panel(idx, vals, X, run, vals_b, name == "union_panel_bf16")
    Y = torch.empty_like(X)
    T, K = idx.shape[0], idx.shape[1] * run
    lib = _build.load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        if name == "union_panel_bf16":
            rc = lib.union_panel_bf16(idx.data_ptr(), vals.data_ptr(),
                                      X.data_ptr(), Y.data_ptr(), T, K, run,
                                      X.shape[0], stream)
        else:
            rc = lib.union_panel_f32(
                idx.data_ptr(), vals.data_ptr(),
                None if vals_b is None else vals_b.data_ptr(), X.data_ptr(),
                Y.data_ptr(), T, K, run, X.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return Y


def panel_launch_shape(T: int, K: int, kind: str = "f32") -> dict:
    """The launch the panel kernel of `kind` ("f32", "f32_fused" for u2_km,
    "bf16") makes at (T, K) on the current card: grid (blocks), warps a
    block, dynamic shared memory bytes and resident blocks per SM (the
    occupancy API's count); see csrc/union_probes.cu. Needs the card."""
    import ctypes

    from maxwell_tpu_torch.kernels import _build

    kinds = ("f32", "f32_fused", "bf16")
    out = (ctypes.c_int64 * 4)()
    rc = _build.load().union_panel_shape(kinds.index(kind), T, K,
                                         ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"union_panel_shape: CUDA error {rc}")
    return dict(zip(("grid", "warps", "smem", "blocks_per_sm"), out))


def u0_hi(cols, vals, X):
    """K15a u0_hi (exp_union.py:79-104, HIGHEST): the panel of UC single
    block columns per tile, true f32 products."""
    if X.device.type == "cpu":
        return u0_hi_ref(cols, vals, X)
    Y = _panel_cuda("union_panel_f32", cols, vals, X, 8)
    u0_hi.launches += 1
    return Y


def u0_def(cols, vals, X):
    """K15a u0_def (the same kernel at DEFAULT precision): bf16 operands,
    f32 sums."""
    if X.device.type == "cpu":
        return u0_def_ref(cols, vals, X)
    Y = _panel_cuda("union_panel_bf16", cols, vals, X, 8)
    u0_def.launches += 1
    return Y


def u1_runs(rcols, vals, X):
    """K15a u1_runs (exp_union.py:107-134): the panel gathered as UC / 8
    runs of 64 contiguous X rows."""
    if X.device.type == "cpu":
        return u1_runs_ref(rcols, vals, X)
    Y = _panel_cuda("union_panel_f32", rcols, vals, X, 64)
    u1_runs.launches += 1
    return Y


def u2_km(rcols, vals, vals_b, X):
    """K15a u2_km (exp_union.py:137-172): u1's gather feeding two value
    streams; Y = Yk + Ym, as the probe sums them."""
    if X.device.type == "cpu":
        return u2_km_ref(rcols, vals, vals_b, X)
    Y = _panel_cuda("union_panel_f32", rcols, vals, X, 64, vals_b)
    u2_km.launches += 1
    return Y


def union_unstaged(A: BELLUnion, X: torch.Tensor) -> torch.Tensor:
    """K15b (exp_union2.py:63-109): Y = A @ X (stream a, f32), X
    (rows <= n_cols_padded, m) zero-padded to n_cols_padded rows, read
    from global memory by the kernel; Y (n_padded, m). It reads the
    layout's live form, as K2 does, with K2's checks: a layout without it
    raises."""
    if X.device.type == "cpu":
        return union_unstaged_ref(A, X)
    pairs = spmm._live_pairs(A, "a", "highest")
    spmm._check_cuda(A, X, pairs)
    if A.b % 4:  # a lane's four X rows must be consecutive
        raise ValueError(f"union_unstaged needs b % 4 == 0, got b = {A.b}")
    Xp = spmm._pad_rows(X, A.n_cols_padded)
    if Xp.data_ptr() % 16:  # its rows are read with 16-byte loads
        raise ValueError("X must be 16-byte aligned")
    Y = torch.empty((A.n_padded, X.shape[1]), dtype=torch.float32,
                    device=X.device)
    _launch("union_unstaged_f32", Xp, pairs[0][0].data_ptr(),
            *spmm._tables(A), Xp.data_ptr(), Y.data_ptr(), A.n_tiles,
            X.shape[1], A.cl, A.b)
    union_unstaged.launches += 1
    return Y


KERNELS = (u0_hi, u0_def, u1_runs, u2_km, union_unstaged)
PLAIN = (u0_hi_ref, u0_def_ref, u1_runs_ref, u2_km_ref, union_unstaged_ref)


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
