"""BELLPairs per-tile cost probes (K15d): the CUDA kernels' wrappers and
their plain PyTorch versions. No solver calls them; the probe script
maxwell_tpu_torch/bench/exp_grid.py does.

The probe of maxwell_tpu/bench/exp_grid.py: T tiles of R = 16 block rows
of b = 8 rows, m = 8 columns; Y is (128 T, 8), tile t its rows
[128 t, 128 t + 128). cols (16 T, Q) int32 are block columns (Q = NCH * Cp
= 48 pair slots per block row, of which the first `live` * 8 are read), nch
(T,) int32 live chunk counts, vals (128 T, 16 Q) f32 the pair value panels,
X (rows, 8) f32; a pair slice of X is X[8 c : 8 c + 16].

    e0_grid1(X, T)                 each tile = X[0:128], one block per tile
    e1_grid6(X, T)                 the same over a (T, 6) grid, written at
                                   j = 0 only
    e2_grid6_when(nch, X)          X[0:128], then + X[0:128] at each chunk
                                   step j < min(nch[t], 6)
    e3_acc424(cols, X, live)       the (16, 8) sum of the tile's 16 x 8 live
                                   slices per chunk, accumulated, tiled 8
                                   times
    e4_cat424(cols, X, live)       per block row r < 8, the (16, 8) sum of its
                                   8 live slices per chunk, stacked
    e5_cat424_mm(cols, vals, X, live)   per block row r: Y_r = sum over the
                                   live slots s of vals[8r:8r+8, 16s:16s+16]
                                   @ X[8 cols[r, s] : +16], f32

e4 and e5 run on a persistent grid that `row_plan` sizes: one block an
SM, the block rows cut into near-equal ranges, each warp a share of its
block's rows walked through a ring of chunk stages in shared memory. e3 is
gather_sum<16, 8> of csrc/gather_probes.cu (g1's function on the first
live * 8 slots), launched as `gather_probes.gather_plan` says.

A wrapper given CUDA tensors checks them and launches its kernel
(csrc/grid_probes.cu; e3: csrc/gather_probes.cu) or raises; given CPU
tensors it runs the plain version (`*_ref`). Each wrapper counts its
launches in `.launches`, each plain version its calls in `.calls`.
`PLAIN_OF` maps each wrapper to the plain arithmetic without a count: the
probe script's oracles, whose comparison launches do not count as the
probe's path.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from maxwell_tpu_torch.kernels import gather_probes as gpr

R, B, M, CP = 16, 8, 8, 8  # block rows per tile, block size, X width, slots
NCH = 6  # chunk steps of the reference's (T, 6) grids
TILE = R * B  # output rows per tile


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def copy_plain(X, T):
    return X[:TILE].repeat(T, 1)


def steps_plain(nch, X):
    """X[0:128] per tile, then + X[0:128] once per live step, in the
    kernel's order of additions."""
    base = X[:TILE]
    live = nch.clamp(0, NCH)
    acc = base.expand(nch.shape[0], TILE, M).clone()
    for j in range(NCH):
        acc = torch.where((j < live)[:, None, None], acc + base, acc)
    return acc.reshape(-1, M)


def slices(cols, X, live_slots):
    """(rows, live_slots, 16, 8): the X slice of each block row's first
    live_slots pair slots."""
    c = cols[:, :live_slots].long()
    rows = c[:, :, None] * B + torch.arange(2 * B, device=cols.device)
    return X[rows]


def acc_plain(cols, X, live):
    T = cols.shape[0] // R
    S = slices(cols, X, live * CP).view(T, R * live * CP, 2 * B, M).sum(1)
    return S.repeat(1, TILE // (2 * B), 1).reshape(-1, M)


def cat_plain(cols, X, live):
    T = cols.shape[0] // R
    S = slices(cols, X, live * CP).sum(1).view(T, R, 2 * B, M)
    return S[:, : R // 2].reshape(-1, M)  # the first 128 rows of the stack


def cat_mm_plain(cols, vals, X, live):
    nbr, Q = cols.shape
    k = live * CP * 2 * B
    V = vals.view(nbr, B, Q * 2 * B)[:, :, :k]
    P = slices(cols, X, live * CP).reshape(nbr, k, M)
    return torch.bmm(V, P).reshape(-1, M)


def e0_grid1_ref(X, T):
    """Plain version of e0_grid1."""
    e0_grid1_ref.calls += 1
    return copy_plain(X, T)


def e1_grid6_ref(X, T):
    """Plain version of e1_grid6."""
    e1_grid6_ref.calls += 1
    return copy_plain(X, T)


def e2_grid6_when_ref(nch, X):
    """Plain version of e2_grid6_when."""
    e2_grid6_when_ref.calls += 1
    return steps_plain(nch, X)


def e3_acc424_ref(cols, X, live):
    """Plain version of e3_acc424."""
    e3_acc424_ref.calls += 1
    return acc_plain(cols, X, live)


def e4_cat424_ref(cols, X, live):
    """Plain version of e4_cat424."""
    e4_cat424_ref.calls += 1
    return cat_plain(cols, X, live)


def e5_cat424_mm_ref(cols, vals, X, live):
    """Plain version of e5_cat424_mm."""
    e5_cat424_mm_ref.calls += 1
    return cat_mm_plain(cols, vals, X, live)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check(X, T, *, nch=None, cols=None, live=None, vals=None) -> None:
    if X.dtype != torch.float32 or X.dim() != 2 or X.shape[1] != M:
        raise ValueError(f"X must be f32 (rows, {M}), got {X.dtype} "
                         f"{tuple(X.shape)}")
    if T < 1:
        raise ValueError(f"T = {T} must be >= 1")
    need = TILE if cols is None else TILE * T + B
    if X.shape[0] < need:
        raise ValueError(f"X needs >= {need} rows, got {X.shape[0]}")
    if nch is not None and (nch.dtype != torch.int32
                            or tuple(nch.shape) != (T,)):
        raise ValueError(f"nch must be int32 ({T},), got {nch.dtype} "
                         f"{tuple(nch.shape)}")
    if cols is not None:
        if cols.dtype != torch.int32 or cols.dim() != 2:
            raise ValueError(f"cols must be int32 (16 T, Q), got "
                             f"{cols.dtype} {tuple(cols.shape)}")
        if cols.shape[0] < R or cols.shape[0] % R:
            raise ValueError(f"cols has {cols.shape[0]} block rows, not a "
                             f"positive multiple of {R}")
        if not 1 <= live * CP <= cols.shape[1]:
            raise ValueError(f"live = {live} chunks of {CP} slots do not fit "
                             f"Q = {cols.shape[1]}")
    if vals is not None and (vals.dtype != torch.float32 or tuple(
            vals.shape) != (B * cols.shape[0], 2 * B * cols.shape[1])):
        raise ValueError(f"vals must be f32 ({B * cols.shape[0]}, "
                         f"{2 * B * cols.shape[1]}), got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    for t in (X, nch, cols, vals):
        if t is None:
            continue
        if t.device != X.device:
            raise ValueError(f"an operand on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned")
    if cols is not None:
        check_cols(cols, X, live)


def check_cols(cols, X, live) -> None:
    """Raise unless every read block column c of cols[:, :live * 8] has
    its slice X[8 c : 8 c + 16] inside X. The kernels read X there
    unchecked. The values are read once per tensor version (a device
    reduction and a sync), and the result is kept on the tensor, so that
    a timed repeat launches the kernel alone."""
    key = (cols._version, X.shape[0], live)
    if getattr(cols, "_grid_probe_cols_ok", None) == key:
        return
    used = cols[:, :live * CP]
    lo, hi = int(used.min()), int(used.max())
    top = (X.shape[0] - 2 * B) // B
    if lo < 0 or hi > top:
        raise ValueError(f"cols in [{lo}, {hi}] leave [0, {top}], the block "
                         f"columns whose slices lie in X's {X.shape[0]} rows")
    cols._grid_probe_cols_ok = key


# e4 / e5's launch (csrc/grid_probes.cu, where these are compile-time
# constants): one block an SM, each warp a ring of 2 chunk stages (e4 4 KB
# a stage, e5 8 KB)
ROW_WARPS = {"cat": 16, "cat_mm": 8}
ROW_STAGES = 2
STAGE_BYTES = {"cat": CP * 2 * B * M * 4, "cat_mm": 2 * CP * 2 * B * M * 4}
KIND = {"cat": 0, "cat_mm": 1}  # the C entries' kind
MAX_SLOTS = 64  # a row's columns ride in two registers a lane


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """e4's ("cat") or e5's ("cat_mm") launch (see row_plan). Block b
    takes the block rows starts()[b] .. starts()[b + 1]; its warp w the
    rows starts()[b] + w + k warps of them (rows()), each walked chunk by
    chunk through the warp's ring."""

    kind: str
    nbr: int  # block rows (16 T)
    live: int  # chunks of 8 slots a row reads
    grid: int  # blocks
    sms: int

    @property
    def warps(self) -> int:
        return ROW_WARPS[self.kind]

    @property
    def stages(self) -> int:
        return ROW_STAGES

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def smem(self) -> int:
        """A block's dynamic shared memory: the warps' rings, and e5's
        barriers (8 bytes a stage)."""
        per = STAGE_BYTES[self.kind] + (8 if self.kind == "cat_mm" else 0)
        return self.warps * self.stages * per

    def starts(self) -> np.ndarray:
        """(grid + 1,) the first row of each block's range, then nbr: the
        kernel's b nbr / grid."""
        b = np.arange(self.grid + 1, dtype=np.int64)
        return b * self.nbr // self.grid

    def rows(self, b: int, w: int) -> np.ndarray:
        """The block rows of block b's warp w, in the order it walks them."""
        s = self.starts()
        return np.arange(s[b] + w, s[b + 1], self.warps, dtype=np.int64)

    def summary(self) -> dict:
        """The launch as the probe records it: grid, warps, threads,
        stages, shared memory, the blocks' and warps' row counts (least,
        most, mean)."""
        per_block = np.diff(self.starts())
        per_warp = np.concatenate([
            np.full(self.warps, n // self.warps)
            + (np.arange(self.warps) < n % self.warps) for n in per_block])
        return {"grid": self.grid, "warps": self.warps,
                "threads": self.threads, "stages": self.stages,
                "smem": self.smem,
                "block_rows": {"min": int(per_block.min()),
                               "max": int(per_block.max()),
                               "mean": float(per_block.mean())},
                "warp_rows": {"min": int(per_warp.min()),
                              "max": int(per_warp.max()),
                              "mean": float(per_warp.mean())}}


def row_plan(nbr: int, live: int, sms: int, kind: str) -> RowPlan:
    """e4's or e5's launch for nbr block rows reading `live` chunks each on
    a card of `sms` SMs: one block an SM, at most one a row."""
    if kind not in KIND:
        raise ValueError(f"kind must be one of {tuple(KIND)}, got {kind!r}")
    plan = RowPlan(kind=kind, nbr=int(nbr), live=int(live),
                   grid=min(int(sms), int(nbr)), sms=int(sms))
    if not 1 <= plan.live * CP <= MAX_SLOTS or plan.grid < 1:
        raise ValueError(f"no launch: {plan}")
    return plan


def rows_shape(plan: RowPlan) -> dict:
    """The plan's launch on the current card: registers and local memory
    bytes a thread, resident blocks per SM (the occupancy API's count at
    its shared memory), the SM count, the shared memory and the warps a
    block, as the kernel was built; see csrc/grid_probes.cu
    grid_rows_shape. Raises where the build and the plan disagree. Needs
    the card."""
    from maxwell_tpu_torch.kernels import _build

    out = (ctypes.c_int64 * 6)()
    rc = _build.load().grid_rows_shape(KIND[plan.kind],
                                       ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"grid_rows_shape: error {rc}")
    shape = dict(zip(("registers", "local_bytes", "blocks_per_sm", "sms",
                      "smem", "warps"), out))
    if (shape["smem"], shape["warps"]) != (plan.smem, plan.warps):
        raise RuntimeError(f"the {plan.kind} kernel was built for "
                           f"{shape['warps']} warps and {shape['smem']} "
                           f"bytes, the plan has {plan.warps} and "
                           f"{plan.smem}")
    return shape


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def run_rows(plan: RowPlan, cols, X, vals=None):
    """e4's (vals None) or e5's launch of `plan` on checked CUDA operands
    into a new (8 nbr, 8) Y. Uncounted: the wrappers that launch it
    count."""
    T = cols.shape[0] // R
    ints = (plan.nbr, cols.shape[1], plan.live, plan.grid)
    if plan.kind == "cat":
        return _launch("grid_cat_f32", X, T, (cols, X), ints)
    return _launch("grid_cat_mm_f32", X, T, (cols, vals, X), ints)


def _launch(name, X, T, inputs, ints):
    """csrc/grid_probes.cu's `name`(*inputs, Y, *ints, stream) into a new
    (128 T, 8) Y; raises on a CUDA error."""
    from maxwell_tpu_torch.kernels import _build

    Y = torch.empty((TILE * T, M), dtype=torch.float32, device=X.device)
    lib = _build.load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = getattr(lib, name)(*(t.data_ptr() for t in inputs),
                                Y.data_ptr(), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return Y


def e0_grid1(X, T):
    """K15d e0_grid1 (exp_grid.py:69-78): the cost of one block per tile."""
    if X.device.type == "cpu":
        return e0_grid1_ref(X, T)
    _check(X, T)
    Y = _launch("grid_copy_f32", X, T, (X,), (T, 1))
    e0_grid1.launches += 1
    return Y


def e1_grid6(X, T):
    """K15d e1_grid6 (exp_grid.py:83-96): six blocks per tile, five of them
    empty."""
    if X.device.type == "cpu":
        return e1_grid6_ref(X, T)
    _check(X, T)
    Y = _launch("grid_copy_f32", X, T, (X,), (T, NCH))
    e1_grid6.launches += 1
    return Y


def e2_grid6_when(nch, X):
    """K15d e2_grid6_when (exp_grid.py:101-121): one block per tile walking
    its chunk steps in a loop that stops at the tile's live count."""
    if X.device.type == "cpu":
        return e2_grid6_when_ref(nch, X)
    T = nch.shape[0]
    _check(X, T, nch=nch)
    Y = _launch("grid_steps_f32", X, T, (nch, X), (T, NCH))
    e2_grid6_when.launches += 1
    return Y


def acc_plan(cols, live, sms):
    """e3's launch: gather_sum's plan over the first live * 8 slots of each
    row, 16-row slices at m 8."""
    return gpr.gather_plan(cols, M, sms, rows=2 * B, slots=live * CP)


def e3_acc424(cols, X, live):
    """K15d e3_acc424 (exp_grid.py:124-141): the tile's X slices summed in
    registers as they arrive, on gather_sum's even split of the slots."""
    if X.device.type == "cpu":
        return e3_acc424_ref(cols, X, live)
    T = cols.shape[0] // R
    _check(X, T, cols=cols, live=live)
    Y = torch.empty((TILE * T, M), dtype=torch.float32, device=X.device)
    gpr.run_plan(acc_plan(cols, live, _sms(X.device)), cols, X, Y)
    e3_acc424.launches += 1
    return Y


def e4_cat424(cols, X, live):
    """K15d e4_cat424 (exp_grid.py:143-170): each row's slices staged in
    shared memory per chunk by cp.async, then summed."""
    if X.device.type == "cpu":
        return e4_cat424_ref(cols, X, live)
    T = cols.shape[0] // R
    _check(X, T, cols=cols, live=live)
    Y = run_rows(row_plan(cols.shape[0], live, _sms(X.device), "cat"),
                 cols, X)
    e4_cat424.launches += 1
    return Y


def e5_cat424_mm(cols, vals, X, live):
    """K15d e5_cat424_mm (exp_grid.py:172-199): K11's arithmetic at the
    probe's shape, f32 FMAs on value boxes (bulk copies) and X slices
    (cp.async) brought into shared memory."""
    if X.device.type == "cpu":
        return e5_cat424_mm_ref(cols, vals, X, live)
    T = cols.shape[0] // R
    _check(X, T, cols=cols, live=live, vals=vals)
    Y = run_rows(row_plan(cols.shape[0], live, _sms(X.device), "cat_mm"),
                 cols, X, vals)
    e5_cat424_mm.launches += 1
    return Y


KERNELS = (e0_grid1, e1_grid6, e2_grid6_when, e3_acc424, e4_cat424,
           e5_cat424_mm)
PLAIN = (e0_grid1_ref, e1_grid6_ref, e2_grid6_when_ref, e3_acc424_ref,
         e4_cat424_ref, e5_cat424_mm_ref)
# each wrapper's plain arithmetic, uncounted
PLAIN_OF = {e0_grid1: copy_plain, e1_grid6: copy_plain,
            e2_grid6_when: steps_plain, e3_acc424: acc_plain,
            e4_cat424: cat_plain, e5_cat424_mm: cat_mm_plain}


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
