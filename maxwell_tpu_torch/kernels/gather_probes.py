"""X-gather probes (K15e): the CUDA kernels' wrappers and their plain
PyTorch versions. No solver calls them; the probe script
maxwell_tpu_torch/bench/exp_gather.py does.

The probe of maxwell_tpu/bench/exp_gather.py: T tiles of R = 16 block rows
of b = 8 rows, S slots per block row, m = 8 columns, P = S b panel rows.
cols (16 T, S) int32 are block columns, X (n, 8) f32 with n = 128 T.

    g0_slices(cols, X)         per tile the sum of its R S slices
                               X[8 c : 8 c + 8], tiled R times: (128 T, 8)
    g1_slices2x(cols, Xp)      the sum of the first S / 2 slots' 16-row
                               slices Xp[8 c : 8 c + 16] of X padded by 8
                               zero rows, tiled 8 times: (128 T, 8)
    g4_lane_ds(cols, XTp)      g1's slices from X^T padded by 8 zero
                               columns, (8, n + 8): XTp[:, 8 c : 8 c + 16];
                               the (8, 16) sum tiled S times along the row:
                               (8 T, 16 S)
    g2_taa0(idx, X, P)         g[p, j] = X[idx[t P + p, j], j] for the
                               tile's (P, 8) idx block; out g[0:8] +
                               g[P - 8:P]: (8 T, 8)
    g3_taa1(idx, XT)           g[j, p] = XT[j, idx[t 8 + j, p]] for p < P
                               = idx.shape[1], XT (8, n): (8 T, P)
    g3w_taa1_wide(idx, XTW, P) the same from the tile's own (8, W) block of
                               XTW (8 T, W), the first P of idx's W columns:
                               (8 T, P)
    g5_floor(X, T)             X[0:128] per tile (no gather): (128 T, 8),
                               the kernel of K15d's e0_grid1

`gather_sum(cols, X)` is g0's kernel at any m in {8, 32, 64, 128}; the
blocked-ELL probe's v4_gather (kernels/spmm_probes.py) launches it. g0, g1,
g4 and v4 share its body, launched as `gather_plan` says: a persistent grid
of SUM_BLOCKS blocks an SM, the T R slots cut into near-equal ranges
(`ranges`), every slice read from L2 (through L1, which serves a tile's
repeated block columns).

A wrapper given CUDA tensors checks them and launches its kernel
(csrc/gather_probes.cu: g3 `taa1`, g3w `taa1_wide`; g5:
csrc/grid_probes.cu) or raises; given CPU
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

R, B, M = 16, 8, 8  # block rows per tile, block size, the probe's width
TILE = R * B  # output rows per tile
SLICE_MS = (8, 32, 64, 128)  # widths gather_sum is built for


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def slice_sum(cols, X, slots, rows):
    """(T, rows, m): per tile, the sum over its R block rows' first `slots`
    slots of X[8 c : 8 c + rows]."""
    T = cols.shape[0] // R
    c = cols[:, :slots].reshape(T, R * slots).long()
    at = c[..., None] * B + torch.arange(rows, device=X.device)
    return X[at].sum(1)


def sum_plain(cols, X):
    """g0 (and v4_gather at any m): the (8, m) sum tiled R times."""
    return slice_sum(cols, X, cols.shape[1], B).repeat(1, R, 1).reshape(
        -1, X.shape[1])


def sum2x_plain(cols, Xp):
    return slice_sum(cols, Xp, cols.shape[1] // 2, 2 * B).repeat(
        1, R // 2, 1).reshape(-1, Xp.shape[1])


def lane_plain(cols, XTp):
    """g4: the (m, 16) slice sums of X^T, tiled S times along each row."""
    S = cols.shape[1]
    s = slice_sum(cols, XTp.T, S // 2, 2 * B)  # (T, 16, m)
    return s.transpose(1, 2).repeat(1, 1, S).reshape(-1, 2 * B * S)


def two_rows(g, P):
    """g (T P, m) -> per tile g[0:8] + g[P - 8:P], (8 T, m)."""
    m = g.shape[1]
    g = g.view(-1, P, m)
    return (g[:, :B] + g[:, P - B:]).reshape(-1, m)


def taa0_plain(idx, X, P):
    """g2: g[p, j] = X[idx[t P + p, j], j], then two_rows."""
    return two_rows(torch.gather(X[:P], 0, idx.long()), P)


def taa1_plain(idx, XT):
    m, P = XT.shape[0], idx.shape[1]
    src = XT[:, :P].expand(idx.shape[0] // m, m, P)
    return torch.gather(src, 2, idx.long().view(-1, m, P)).reshape(-1, P)


def taa1w_plain(idx, XTW, P):
    W = XTW.shape[1]
    i = idx.long().view(-1, M, W)[:, :, :P]
    return torch.gather(XTW.view(-1, M, W), 2, i).reshape(-1, P)


def copy_plain(X, T):
    return X[:TILE].repeat(T, 1)


def g0_slices_ref(cols, X):
    """Plain version of g0_slices."""
    g0_slices_ref.calls += 1
    return sum_plain(cols, X)


def g1_slices2x_ref(cols, Xp):
    """Plain version of g1_slices2x."""
    g1_slices2x_ref.calls += 1
    return sum2x_plain(cols, Xp)


def g4_lane_ds_ref(cols, XTp):
    """Plain version of g4_lane_ds."""
    g4_lane_ds_ref.calls += 1
    return lane_plain(cols, XTp)


def g2_taa0_ref(idx, X, P):
    """Plain version of g2_taa0."""
    g2_taa0_ref.calls += 1
    return taa0_plain(idx, X, P)


def g3_taa1_ref(idx, XT):
    """Plain version of g3_taa1."""
    g3_taa1_ref.calls += 1
    return taa1_plain(idx, XT)


def g3w_taa1_wide_ref(idx, XTW, P):
    """Plain version of g3w_taa1_wide."""
    g3w_taa1_wide_ref.calls += 1
    return taa1w_plain(idx, XTW, P)


def g5_floor_ref(X, T):
    """Plain version of g5_floor."""
    g5_floor_ref.calls += 1
    return copy_plain(X, T)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def check_operands(*tensors, dtypes) -> None:
    """Each tensor on the first's device, contiguous, 16-byte aligned and of
    its dtype in `dtypes`."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise ValueError(f"an operand is {t.dtype}, expected {dt}")
        if t.device != dev:
            raise ValueError(f"an operand on {t.device}, another on {dev}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned")


def check_range(idx, hi: int, what: str, read: int | None = None) -> None:
    """Raise unless every value of idx[:, :read] (all of idx if read is
    None) lies in [0, hi]: the kernels index with it unchecked. The values
    are read once per tensor version, bound and width (a device reduction
    and a sync), and the result is kept on the tensor, so that a timed
    repeat launches the kernel alone."""
    key = (idx._version, hi, read)
    if getattr(idx, "_probe_range_ok", None) == key:
        return
    used = idx if read is None else idx[:, :read]
    lo, top = int(used.min()), int(used.max())
    if lo < 0 or top > hi:
        raise ValueError(f"{what} in [{lo}, {top}] leave [0, {hi}]")
    idx._probe_range_ok = key


def check_cols(cols, x_rows: int, slots: int, rows: int) -> None:
    """cols (16 T, S) int32 with S even and slots <= S, whose read block
    columns c (the first `slots` of each row) have X[8 c : 8 c + rows]
    inside X's x_rows rows."""
    if cols.dim() != 2 or cols.shape[0] < R or cols.shape[0] % R:
        raise ValueError(f"cols must be (16 T, S), got {tuple(cols.shape)}")
    if cols.shape[1] % 2 or not 1 <= slots <= cols.shape[1]:
        raise ValueError(f"S = {cols.shape[1]} must be even, {slots} slots "
                         "read")
    top = (x_rows - rows) // B
    if top < 0:
        raise ValueError(f"X has {x_rows} rows, fewer than a slice")
    check_range(cols, top, "the read block columns", slots)


def launch(name, *args):
    """csrc's `name`(*args, stream); raises on a CUDA error. Tensors pass
    as their data pointers."""
    from maxwell_tpu_torch.kernels import _build

    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(*(a.data_ptr() if isinstance(
            a, torch.Tensor) else a for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


# gather_sum's launch (csrc/gather_probes.cu): a persistent grid of
# SUM_BLOCKS blocks of SUM_WARPS warps an SM, the slot list cut into near-
# equal ranges of whole groups of 4 slots
SUM_WARPS = 8
SUM_BLOCKS = 2  # resident blocks an SM (the kernel's launch bounds)
GROUP = 4  # slots of an index group (one int4), the ranges' unit


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """gather_sum's launch (see gather_plan). Block b sums the slots
    ranges()[b] .. ranges()[b + 1] of the T R slots in (tile, block row,
    slot) order, tile piece by tile piece; a tile cut by a range boundary
    is summed piece by piece and the pieces added in range order."""

    T: int
    S: int
    slots: int  # read from each cols row, its first (S or S / 2)
    rows: int  # of a slice: 8 (g0, v4) or 16 (g1, g4)
    m: int
    transposed: bool  # g4: slices of X^T
    grid: int  # blocks
    sms: int

    @property
    def n(self) -> int:
        """Slots of a tile."""
        return R * self.slots

    @property
    def groups(self) -> int:
        return self.T * self.n // GROUP

    def ranges(self) -> np.ndarray:
        """(grid + 1,) the first slot of each block's range, then T n: the
        kernel's range_start, 4 floor(b groups / grid)."""
        b = np.arange(self.grid + 1, dtype=np.int64)
        return GROUP * (b * self.groups // self.grid)

    def block_of(self, e):
        """The block whose range holds slot e (the kernel's block_of)."""
        e = np.asarray(e, dtype=np.int64)
        return ((e // GROUP + 1) * self.grid + self.groups - 1) \
            // self.groups - 1

    def cut_tiles(self) -> int:
        """Tiles that two or more ranges share."""
        t = np.arange(self.T, dtype=np.int64)
        return int((self.block_of((t + 1) * self.n - 1)
                    != self.block_of(t * self.n)).sum())

    @property
    def slice_bytes(self) -> int:
        """A slice: rows x m floats, or of X^T m rows of 16."""
        return 4 * self.m * (16 if self.transposed else self.rows)

    def summary(self, cols=None) -> dict:
        """The launch as the probes record it: grid and threads; the
        blocks' slot counts (least, most, mean, the most's excess over the
        mean in %); cut tiles; the slice bytes every slot reads (from L2,
        or L1 where a tile repeats a block column). Given the plan's cols,
        also the tiles' union sizes (tile_unions: least, mean, largest) and
        union_bytes, their slices (each distinct slice of a tile once)."""
        loads = np.diff(self.ranges())
        out = {"grid": self.grid, "threads": 32 * SUM_WARPS,
               "block_slots": {"min": int(loads.min()),
                               "max": int(loads.max()),
                               "mean": float(loads.mean()),
                               "max_over_mean_pct": float(
                                   100 * (loads.max() / loads.mean() - 1))},
               "cut_tiles": self.cut_tiles(),
               "bytes_slices": self.T * self.n * self.slice_bytes}
        if cols is not None:
            u = tile_unions(cols, self.slots)
            out["unions"] = {"min": min(u), "mean": sum(u) / self.T,
                             "max": max(u), "slots": self.n}
            out["union_bytes"] = sum(u) * self.slice_bytes
        return out


def tile_unions(cols, slots: int) -> tuple:
    """(T,) distinct block columns among each tile's R rows' first `slots`
    slots (one sort on cols' device): the probes' record of how often a
    tile repeats a slice."""
    T = cols.shape[0] // R
    u = cols[:, :slots].reshape(T, R * slots).sort(dim=1).values
    sizes = 1 + (u[:, 1:] != u[:, :-1]).sum(dim=1)
    return tuple(int(v) for v in sizes.cpu())


def gather_plan(cols, m: int, sms: int, rows: int = B, slots=None,
                transposed: bool = False) -> GatherPlan:
    """gather_sum's launch for cols (16 T, S) at width m on a card of `sms`
    SMs, reading each row's first `slots` slots (all by default) as slices
    of `rows` rows (transposed: of X^T): SUM_BLOCKS blocks an SM, at most
    one a group of 4 slots."""
    T, S = cols.shape[0] // R, cols.shape[1]
    slots = S if slots is None else int(slots)
    groups = T * R * slots // GROUP
    return GatherPlan(T=T, S=S, slots=slots, rows=rows, m=int(m),
                      transposed=bool(transposed),
                      grid=min(int(sms) * SUM_BLOCKS, groups), sms=int(sms))


def launch_shape(plan: GatherPlan) -> dict:
    """The plan's launch on the current card: registers and local memory
    bytes a thread, resident blocks per SM (the occupancy API's count),
    the SM count and a block's shared memory; see csrc/gather_probes.cu
    gather_sum_shape. Needs the card."""
    from maxwell_tpu_torch.kernels import _build

    out = (ctypes.c_int64 * 5)()
    rc = _build.load().gather_sum_shape(
        plan.rows, plan.m, int(plan.transposed), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"gather_sum_shape: error {rc}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "sms",
                     "smem"), out))


def l2_read(x, out):
    """Every one of out.numel() blocks reads x (f32, a multiple of 4
    floats) through L2 and adds its sum to its float of out, zeroed here:
    bench/timing.py's L2 read rate. Ports no TPU kernel; uncounted."""
    if x.dtype != torch.float32 or x.numel() % 4 or not x.is_contiguous():
        raise ValueError("x must be contiguous f32, a multiple of 4 floats")
    check_operands(x, out, dtypes=(torch.float32, torch.float32))
    out.zero_()
    launch("l2_read_f32", x, out, x.numel() // 4, out.numel())
    return out


_COUNTERS = {}  # (device, stream) -> int32 [>= T], zero between launches


def run_plan(plan: GatherPlan, cols, X, Y, x_stride: int = 0) -> None:
    """gather_sum's launch of `plan` on checked CUDA operands into Y:
    scratch rows for the cut tiles, and the tiles' counters of the current
    stream (zero between launches: the kernel leaves them so, and the
    launches of one stream run in turn). A launch that fails drops its
    stream's counters, so that the next starts from fresh zeros."""
    stream = torch.cuda.current_stream(X.device).cuda_stream
    key = (X.device, stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < plan.T:
        counters = torch.zeros(max(plan.T, 1024), dtype=torch.int32,
                               device=X.device)
        _COUNTERS[key] = counters
    scratch = torch.empty((2 * plan.grid, plan.slice_bytes // 4),
                          dtype=torch.float32, device=X.device)
    try:
        launch("gather_sum_f32", cols, X, Y, scratch, counters, plan.T,
               plan.S, plan.slots, plan.rows, plan.m, int(plan.transposed),
               x_stride, plan.grid)
    except RuntimeError:
        del _COUNTERS[key]
        raise


def _sum_launch(cols, X, Y, slots, rows, transposed, x_stride):
    """gather_sum on checked CUDA operands: its plan, then its launch."""
    m = X.shape[0] if transposed else X.shape[1]
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    run_plan(gather_plan(cols, m, sms, rows, slots, transposed), cols, X, Y,
             x_stride)


def gather_sum(cols, X) -> torch.Tensor:
    """g0's kernel at any m in SLICE_MS on CUDA tensors: the (8, m) sum of
    each tile's R S slices X[8 c : 8 c + 8], tiled R times. Uncounted: the
    wrappers that launch it count."""
    m = X.shape[1] if X.dim() == 2 else 0
    if m not in SLICE_MS:
        raise ValueError(f"X must be (rows, m) with m in {SLICE_MS}, got "
                         f"{tuple(X.shape)}")
    check_operands(cols, X, dtypes=(torch.int32, torch.float32))
    check_cols(cols, X.shape[0], cols.shape[1], B)
    T, S = cols.shape[0] // R, cols.shape[1]
    Y = torch.empty((TILE * T, m), dtype=torch.float32, device=X.device)
    _sum_launch(cols, X, Y, S, B, False, 0)
    return Y


def _check_m8(X, name="X"):
    if X.dim() != 2 or X.shape[1] != M:
        raise ValueError(f"{name} must be (rows, {M}), got "
                         f"{tuple(X.shape)}")


def g0_slices(cols, X):
    """K15e g0_slices (exp_gather.py:93-113): (8, 8) slices of X, summed
    in registers."""
    if X.device.type == "cpu":
        return g0_slices_ref(cols, X)
    _check_m8(X)
    Y = gather_sum(cols, X)
    g0_slices.launches += 1
    return Y


def g1_slices2x(cols, Xp):
    """K15e g1_slices2x (exp_gather.py:115-135): (16, 8) slices, half the
    slots."""
    if Xp.device.type == "cpu":
        return g1_slices2x_ref(cols, Xp)
    _check_m8(Xp, "Xp")
    check_operands(cols, Xp, dtypes=(torch.int32, torch.float32))
    check_cols(cols, Xp.shape[0], cols.shape[1] // 2, 2 * B)
    T, S = cols.shape[0] // R, cols.shape[1]
    Y = torch.empty((TILE * T, M), dtype=torch.float32, device=Xp.device)
    _sum_launch(cols, Xp, Y, S // 2, 2 * B, False, 0)
    g1_slices2x.launches += 1
    return Y


def g4_lane_ds(cols, XTp):
    """K15e g4_lane_ds (exp_gather.py:218-239): g1's slices from X^T, m
    rows of 16 floats."""
    if XTp.device.type == "cpu":
        return g4_lane_ds_ref(cols, XTp)
    if XTp.dim() != 2 or XTp.shape[0] != M or XTp.shape[1] % 4:
        raise ValueError(f"XTp must be ({M}, n + 8) with n + 8 a multiple "
                         f"of 4, got {tuple(XTp.shape)}")
    check_operands(cols, XTp, dtypes=(torch.int32, torch.float32))
    check_cols(cols, XTp.shape[1], cols.shape[1] // 2, 2 * B)
    T, S = cols.shape[0] // R, cols.shape[1]
    Y = torch.empty((M * T, 2 * B * S), dtype=torch.float32,
                    device=XTp.device)
    _sum_launch(cols, XTp, Y, S // 2, 2 * B, True, XTp.shape[1])
    g4_lane_ds.launches += 1
    return Y


def g2_taa0(idx, X, P):
    """K15e g2_taa0 (exp_gather.py:137-162): per-element gathers down the
    rows of the staged X[0:P]."""
    if X.device.type == "cpu":
        return g2_taa0_ref(idx, X, P)
    _check_m8(X)
    check_operands(idx, X, dtypes=(torch.int32, torch.float32))
    if P < B or P % 4 or X.shape[0] < P:
        raise ValueError(f"P = {P} must be a multiple of 4, >= 8 and <= "
                         f"X's {X.shape[0]} rows")
    if idx.dim() != 2 or idx.shape[1] != M or idx.shape[0] % P or \
            not idx.shape[0]:
        raise ValueError(f"idx must be (T {P}, {M}), got "
                         f"{tuple(idx.shape)}")
    check_range(idx, P - 1, "idx")
    T = idx.shape[0] // P
    Y = torch.empty((B * T, M), dtype=torch.float32, device=X.device)
    launch("gather_taa0_f32", idx, X, Y, T, P, 0, P - B)
    g2_taa0.launches += 1
    return Y


def _check_taa1(idx, src, width, P):
    check_operands(idx, src, dtypes=(torch.int32, torch.float32))
    if idx.dim() != 2 or idx.shape[0] % M or not idx.shape[0] or \
            idx.shape[1] % 4 or idx.shape[1] < P:
        raise ValueError(f"idx must be (8 T, >= {P}) with a multiple of 4 "
                         f"columns, got {tuple(idx.shape)}")
    if P < 4 or P % 4 or width % 4:
        raise ValueError(f"P = {P} and the source width {width} must be "
                         "multiples of 4")
    check_range(idx, width - 1, "idx", P)


def g3_taa1(idx, XT):
    """K15e g3_taa1 (exp_gather.py:164-187): per-element gathers along the
    columns of the staged X^T[:, 0:P], P = idx.shape[1]."""
    if XT.device.type == "cpu":
        return g3_taa1_ref(idx, XT)
    P = idx.shape[1] if idx.dim() == 2 else 0
    if XT.dim() != 2 or XT.shape[0] != M or XT.shape[1] % 4 or \
            XT.shape[1] < P:
        raise ValueError(f"XT must be ({M}, n >= {P}), n a multiple of 4, "
                         f"got {tuple(XT.shape)}")
    _check_taa1(idx, XT, P, P)
    T = idx.shape[0] // M
    Y = torch.empty((M * T, P), dtype=torch.float32, device=XT.device)
    launch("gather_taa1_f32", XT, XT.shape[1], 0, P, idx, P, Y, T, M, P)
    g3_taa1.launches += 1
    return Y


def g3w_taa1_wide(idx, XTW, P):
    """K15e g3w_taa1_wide (exp_gather.py:189-216): g3 from the tile's own
    (8, W) source block, W = XTW.shape[1]; its kernel stages nothing (one
    warp per source row gathers from global memory)."""
    if XTW.device.type == "cpu":
        return g3w_taa1_wide_ref(idx, XTW, P)
    if XTW.dim() != 2 or tuple(XTW.shape) != tuple(idx.shape):
        raise ValueError(f"XTW must be idx's shape {tuple(idx.shape)}, got "
                         f"{tuple(XTW.shape)}")
    W = XTW.shape[1]
    _check_taa1(idx, XTW, W, P)
    Y = torch.empty((idx.shape[0], P), dtype=torch.float32,
                    device=XTW.device)
    launch("gather_taa1_wide_f32", XTW, idx, Y, idx.shape[0], W, P)
    g3w_taa1_wide.launches += 1
    return Y


def g5_floor(X, T):
    """K15e g5_floor (exp_gather.py:241-254): no gather, X[0:128] per
    tile; the kernel of K15d's e0_grid1 (csrc/grid_probes.cu), counted
    here."""
    if X.device.type == "cpu":
        return g5_floor_ref(X, T)
    from maxwell_tpu_torch.kernels import grid_probes as gp

    gp._check(X, T)
    Y = gp._launch("grid_copy_f32", X, T, (X,), (T, 1))
    g5_floor.launches += 1
    return Y


KERNELS = (g0_slices, g1_slices2x, g2_taa0, g3_taa1, g3w_taa1_wide,
           g4_lane_ds, g5_floor)
PLAIN = (g0_slices_ref, g1_slices2x_ref, g2_taa0_ref, g3_taa1_ref,
         g3w_taa1_wide_ref, g4_lane_ds_ref, g5_floor_ref)
# each wrapper's plain arithmetic, uncounted
PLAIN_OF = {g0_slices: sum_plain, g1_slices2x: sum2x_plain,
            g2_taa0: taa0_plain, g3_taa1: taa1_plain,
            g3w_taa1_wide: taa1w_plain, g4_lane_ds: lane_plain,
            g5_floor: copy_plain}


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
