"""Blocked-ELL SpMM probes (K15c): the CUDA kernels' wrappers and their
plain PyTorch versions. No solver calls them; the probe script
maxwell_tpu_torch/bench/exp_spmm.py does.

The probe of maxwell_tpu/bench/exp_spmm.py: a blocked-ELL layout of nbr
block rows (a multiple of R = 16: whole 128-row tiles) of S slots (a
multiple of 4) of 8 x 8 blocks, as the transposed value panel V = blocks2d
(nbr b, S b) f32 (row r b + i, column s b + k, `panel_values`) and cols
(nbr, S) int32; X (rows, m) f32 with m in {8, 32, 64, 128}; Y (nbr b, m).

    v5_batched_hi(V, cols, X)    Y = A X: per slot, X[8 c : 8 c + 8] read
                                 from global memory, products on 3xTF32
                                 mma.sync (f32 grade)
    v1_panel_hi(V, cols, X)      the same, each row's X slices staged in
                                 shared memory through a per-warp cp.async
                                 ring (PANEL_RING)
    v6_smem_hi(V, cols, X)       v5_hi with the tile's cols staged in
                                 shared memory
    v5_batched_def(V, cols, X)   v5 with bf16 operands (nearest even) and
                                 f32 sums (the TPU's DEFAULT precision),
                                 mma.sync m16n8k16, X by 16-byte loads
    v2_panel_def(V, cols, X)     v5_def with X through shared memory: per
                                 unit of UNIT block rows the union of its
                                 block columns, each X slice staged once
                                 in bf16, in passes of PASS columns
                                 (`union_plan`); the later passes read the
                                 values' bf16 B registers from a scratch
                                 stream the first wrote
    v3_stream(V, X)              every block row's values @ the fixed panel
                                 X[0 : S b], bf16 operands
    v3b_onedot(V, X)             the same function, one (128, S b) product
                                 per tile
    v4_gather(cols, X)           per tile the sum of its R S slices
                                 X[8 c : 8 c + 8], tiled R times (the
                                 kernel of K15e's g0_slices)

A wrapper given CUDA tensors checks them and launches its kernel
(csrc/spmm_probes.cu; v4: csrc/gather_probes.cu) or raises; given CPU
tensors it runs the plain version (`*_ref`). Each wrapper counts its
launches in `.launches`, each plain version its calls in `.calls`.
`PLAIN_OF` maps each wrapper to the plain arithmetic without a count: the
probe script's oracles, whose comparison launches do not count as the
probe's path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maxwell_tpu_torch.kernels import gather_probes as gpr

R, B = 16, 8  # block rows per tile, block size
MS = gpr.SLICE_MS  # the widths the kernels are built for
SMEM_LIMIT = 232448  # a block's shared memory on the H100
UNIT = 8  # v2_panel_def: block rows of a unit (a block, two warps a row)
PASS = 32  # v2_panel_def: columns of a pass from m 32 (m 8: one pass of 8)


def panel_values(blocks: torch.Tensor) -> torch.Tensor:
    """blocks (nbr, S, b, b) -> the transposed value panel (nbr b, S b):
    row r b + i, column s b + k (exp_spmm.py:80-85)."""
    nbr, S, b, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(nbr * b, S * b).contiguous()


# v3/v3b: the value ring (stages, bytes a stage) of csrc/spmm_probes.cu's
# Ring<onedot>: a stage is one (rows, 32 f32) box per unit of a step, v3
# three of 16 units' (16 rows), v3b four of two units' (64 rows)
STREAM_RING = {False: (3, 16 * 16 * 32 * 4), True: (4, 2 * 64 * 32 * 4)}


# v1_panel_hi: each of a block's 8 warps (HI_WARPS, half a tile) stages its
# row's X slices through a ring of (stages, slots a stage), as
# csrc/spmm_probes.cu's Hi<m> lays it out (a slot is 8 X rows of m f32); m
# 128 takes 1-slot stages, so that two blocks share an SM
HI_WARPS = 8
PANEL_RING = {8: (4, 4), 32: (3, 2), 64: (3, 2), 128: (3, 1)}


def panel_smem(m: int) -> int:
    """Shared memory of a v1_panel_hi block at width m: 8 warps' rings."""
    stages, slots = PANEL_RING[m]
    return HI_WARPS * stages * slots * B * m * 4


def stream_smem(S: int, m: int, onedot: bool) -> int:
    """Shared memory of a v3_stream (onedot False) or v3b_onedot block at S
    slots and width m, as the kernel lays it out: 1 KB to align the ring,
    the ring, the fixed panel X[0 : S b] in bf16, a full and an empty
    barrier per stage."""
    stages, stage = STREAM_RING[onedot]
    return 1024 + stages * stage + S * B * m * 2 + 2 * stages * 8


def union_sizes(cols) -> torch.Tensor:
    """(nbr / UNIT,) the number of distinct block columns of each unit of
    UNIT block rows: the entries of its v2_panel_def panel."""
    nbr, S = cols.shape
    u = cols.reshape(nbr // UNIT, UNIT * S).sort(dim=1).values
    return 1 + (u[:, 1:] != u[:, :-1]).sum(dim=1)


def largest_union(cols) -> tuple:
    """(the largest union of a unit of cols, whether it was reckoned now):
    reckoned once per tensor version (a device reduction and a sync), kept
    on the tensor like the probes' range checks, so that a timed repeat
    launches the kernel alone."""
    hit = getattr(cols, "_union_largest", None)
    if hit is not None and hit[0] == cols._version:
        return hit[1], False
    largest = int(union_sizes(cols).max())
    cols._union_largest = (cols._version, largest)
    return largest, True


def union_smem(W: int, cap: int, S: int, x_rows: int) -> int:
    """Shared memory of a v2_panel_def block (csrc's union_smem): a panel
    of cap entries of 8 rows x W bf16, the second step halves' sums (UNIT
    rows x 32 lanes x 8 f32), the bitmap over X's x_rows / 8 block columns
    and its prefix (a word each per 32), the places of the unit's UNIT S
    slots, the union's columns, its size."""
    nwords = -(-(x_rows // B) // 32)
    return (cap * 16 * W + UNIT * 32 * 8 * 4 + 8 * nwords + 4 * UNIT * S
            + 4 * cap + 16)


def union_plan(largest: int, S: int, m: int, x_rows: int) -> dict:
    """v2_panel_def's launch for the largest union of the cols it is given:
    passes of PASS columns (8 at m 8) where that panel fits a block's
    shared memory, else of 8; raises where neither fits."""
    for W in ((8,) if m == 8 else (PASS, 8)):
        smem = union_smem(W, largest, S, x_rows)
        if smem <= SMEM_LIMIT:
            return {"unit": UNIT, "pass_width": W, "passes": m // W,
                    "largest_union": largest, "smem": smem}
    raise ValueError(f"v2_panel_def: a union of {largest} block columns "
                     f"takes {union_smem(8, largest, S, x_rows)} bytes of "
                     f"shared memory at 8 columns a pass, more than "
                     f"{SMEM_LIMIT}")


def def_launch_shape(kind: str, m: int, smem: int = 0,
                     passes: int = 1) -> dict:
    """The launch of a _def rung on the current card ("v5" at width m,
    "v2" in `passes` passes of m columns with smem bytes): warps a block,
    registers and local memory bytes a thread, resident blocks per SM (the
    occupancy API's count); see csrc/spmm_probes.cu spmm_def_shape. Needs
    the card."""
    from maxwell_tpu_torch.kernels import _build

    code = {"v5": 0, "v2": 1 if passes == 1 else 2}[kind]
    out = (ctypes.c_int64 * 4)()
    rc = _build.load().spmm_def_shape(code, m, smem, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"spmm_def_shape: CUDA error {rc}")
    return dict(zip(("warps", "registers", "local_bytes", "blocks_per_sm"),
                    out))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def gathered_panel(cols, X):
    """(nbr, S b, m): each block row's X panel, slot s's rows X[8 c : 8 c +
    8] at rows 8 s .. 8 s + 7."""
    nbr, S = cols.shape
    m = X.shape[1]
    return X[: X.shape[0] // B * B].view(-1, B, m)[cols.long()].reshape(
        nbr, S * B, m)


def product_plain(V, cols, X, bf16=False):
    """Y = A X as one bmm of the (nbr, b, S b) values against the gathered
    panels; bf16: both operands rounded to bf16 first, f32 sums."""
    nbr, S = cols.shape
    Vb, P = V.view(nbr, B, S * B), gathered_panel(cols, X)
    if bf16:
        Vb, P = Vb.bfloat16().float(), P.bfloat16().float()
    return torch.bmm(Vb, P).reshape(nbr * B, -1)


def product_def_plain(V, cols, X):
    return product_plain(V, cols, X, bf16=True)


def stream_plain(V, X):
    """V @ X[0 : S b] with bf16-rounded operands and f32 sums."""
    return V.bfloat16().float() @ X[: V.shape[1]].bfloat16().float()


def v5_batched_hi_ref(V, cols, X):
    """Plain version of v5_batched_hi."""
    v5_batched_hi_ref.calls += 1
    return product_plain(V, cols, X)


def v1_panel_hi_ref(V, cols, X):
    """Plain version of v1_panel_hi."""
    v1_panel_hi_ref.calls += 1
    return product_plain(V, cols, X)


def v6_smem_hi_ref(V, cols, X):
    """Plain version of v6_smem_hi."""
    v6_smem_hi_ref.calls += 1
    return product_plain(V, cols, X)


def v5_batched_def_ref(V, cols, X):
    """Plain version of v5_batched_def."""
    v5_batched_def_ref.calls += 1
    return product_def_plain(V, cols, X)


def v2_panel_def_ref(V, cols, X):
    """Plain version of v2_panel_def."""
    v2_panel_def_ref.calls += 1
    return product_def_plain(V, cols, X)


def v3_stream_ref(V, X):
    """Plain version of v3_stream."""
    v3_stream_ref.calls += 1
    return stream_plain(V, X)


def v3b_onedot_ref(V, X):
    """Plain version of v3b_onedot."""
    v3b_onedot_ref.calls += 1
    return stream_plain(V, X)


def v4_gather_ref(cols, X):
    """Plain version of v4_gather."""
    v4_gather_ref.calls += 1
    return gpr.sum_plain(cols, X)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check(V, X, cols=None) -> int:
    """Check the operands; returns m."""
    m = X.shape[1] if X.dim() == 2 else 0
    if m not in MS:
        raise ValueError(f"X must be (rows, m) with m in {MS}, got "
                         f"{tuple(X.shape)}")
    if V.dim() != 2 or V.shape[0] % (R * B) or not V.shape[0] or \
            V.shape[1] % (4 * B) or not V.shape[1]:
        raise ValueError(f"V must be (nbr 8, S 8) with nbr a multiple of "
                         f"{R} and S of 4, got {tuple(V.shape)}")
    nbr, S = V.shape[0] // B, V.shape[1] // B
    if cols is None:
        gpr.check_operands(V, X, dtypes=(torch.float32,) * 2)
        if X.shape[0] < S * B:
            raise ValueError(f"X has {X.shape[0]} rows, the fixed panel "
                             f"needs {S * B}")
        return m
    gpr.check_operands(V, cols, X,
                       dtypes=(torch.float32, torch.int32, torch.float32))
    if tuple(cols.shape) != (nbr, S):
        raise ValueError(f"cols must be ({nbr}, {S}), got "
                         f"{tuple(cols.shape)}")
    gpr.check_cols(cols, X.shape[0], S, B)
    return m


def _product(name, V, cols, X, *flag):
    m = _check(V, X, cols)
    Y = torch.empty((V.shape[0], m), dtype=torch.float32, device=X.device)
    gpr.launch(name, V, cols, X, Y, V.shape[0] // B, V.shape[1] // B, m,
               *flag)
    return Y


_STATUS = {}  # device -> int32 [1]: the largest union a launch refused


def _union(V, cols, X):
    """v2_panel_def's launch: sized for the largest union of cols (reckoned
    once per cols version); on that first launch the kernel's own check
    (a unit whose union exceeds the panel records its size and writes
    nothing past it) is read back and raised."""
    m = _check(V, X, cols)
    nbr, S = cols.shape
    largest, fresh = largest_union(cols)
    plan = union_plan(largest, S, m, X.shape[0])
    status = _STATUS.get(X.device)
    if status is None:
        status = _STATUS[X.device] = torch.zeros(
            1, dtype=torch.int32, device=X.device)
    if fresh:
        status.zero_()
    Y = torch.empty((V.shape[0], m), dtype=torch.float32, device=X.device)
    # the first pass's bf16 B registers for the later passes: 8 bytes a
    # lane, step and block row
    scratch = None if plan["passes"] == 1 else torch.empty(
        (nbr, S // 2, 32, 2), dtype=torch.int32, device=X.device)
    gpr.launch("spmm_union_bf16", V, cols, X, Y, status, scratch, nbr, S, m,
               X.shape[0], largest, plan["pass_width"])
    if fresh and int(status.item()):
        raise RuntimeError(f"v2_panel_def: a unit's union of "
                           f"{int(status.item())} block columns exceeds the "
                           f"panel's {largest}")
    return Y


def _stream(V, X, onedot):
    m = _check(V, X)
    nbr, S = V.shape[0] // B, V.shape[1] // B
    need = stream_smem(S, m, onedot)
    if need > SMEM_LIMIT:
        raise ValueError(f"S = {S} at m = {m}: the bf16 panel and the value "
                         f"ring take {need} bytes of shared memory, more "
                         f"than {SMEM_LIMIT}")
    Y = torch.empty((V.shape[0], m), dtype=torch.float32, device=X.device)
    tmap = _tensor_map(V.data_ptr(), V.device.index, nbr, S, onedot)
    gpr.launch("spmm_stream_bf16", ctypes.addressof(tmap), X, Y, nbr, S, m,
               int(onedot))
    return Y


@functools.lru_cache(maxsize=64)
def _tensor_map(ptr, device, nbr, S, onedot):
    """The TMA descriptor (CUtensorMap, 128 bytes) of the value panel at
    ptr on `device`, (nbr b, S b) f32, with v3's or v3b's box; encoded
    once per pointer and shape (it holds nothing else)."""
    from maxwell_tpu_torch.kernels import _build

    buf = ctypes.create_string_buffer(128)
    rc = _build.load().spmm_stream_tensor_map(ptr, nbr, S, int(onedot), buf)
    if rc != 0:
        raise RuntimeError(f"spmm_stream_tensor_map failed: {rc} (-1: no "
                           "cuTensorMapEncodeTiled, else its CUresult)")
    return buf


def v5_batched_hi(V, cols, X):
    """K15c v5_batched_hi (exp_spmm.py:260-291, HIGHEST): the unstaged
    baseline, X slices from L1/L2 into registers, products on 3xTF32
    mma.sync."""
    if X.device.type == "cpu":
        return v5_batched_hi_ref(V, cols, X)
    Y = _product("spmm_probe_f32", V, cols, X, 0)
    v5_batched_hi.launches += 1
    return Y


def v1_panel_hi(V, cols, X):
    """K15c v1_panel_hi (exp_spmm.py:111-142, HIGHEST): v5_hi with each
    row's X slices staged in shared memory; a width whose ring does not fit
    in SMEM_LIMIT is refused (ValueError), never taken unstaged."""
    if X.device.type == "cpu":
        return v1_panel_hi_ref(V, cols, X)
    m = X.shape[1] if X.dim() == 2 else 0
    if m in PANEL_RING and panel_smem(m) > SMEM_LIMIT:
        raise ValueError(f"v1_panel_hi at m = {m}: the staging ring takes "
                         f"{panel_smem(m)} bytes of shared memory, more "
                         f"than {SMEM_LIMIT}")
    Y = _product("spmm_probe_f32", V, cols, X, 1)
    v1_panel_hi.launches += 1
    return Y


def v6_smem_hi(V, cols, X):
    """K15c v6_smem_hi (exp_spmm.py:226-258): v5_hi with the tile's cols
    staged in shared memory."""
    if X.device.type == "cpu":
        return v6_smem_hi_ref(V, cols, X)
    Y = _product("spmm_probe_f32", V, cols, X, 2)
    v6_smem_hi.launches += 1
    return Y


def v5_batched_def(V, cols, X):
    """K15c v5_batched_def (exp_spmm.py:260-291, DEFAULT): v5 with bf16
    operands through mma.sync, X by 16-byte loads."""
    if X.device.type == "cpu":
        return v5_batched_def_ref(V, cols, X)
    Y = _product("spmm_probe_bf16", V, cols, X)
    v5_batched_def.launches += 1
    return Y


def v2_panel_def(V, cols, X):
    """K15c v2_panel_def (exp_spmm.py:111-142, DEFAULT): X staged in shared
    memory, each unit's union of X slices once, in bf16; a union whose
    panel does not fit is refused (ValueError), never taken unstaged."""
    if X.device.type == "cpu":
        return v2_panel_def_ref(V, cols, X)
    Y = _union(V, cols, X)
    v2_panel_def.launches += 1
    return Y


def v3_stream(V, X):
    """K15c v3_stream (exp_spmm.py:144-171): no gather, one product per
    8-row block against the fixed panel."""
    if X.device.type == "cpu":
        return v3_stream_ref(V, X)
    Y = _stream(V, X, False)
    v3_stream.launches += 1
    return Y


def v3b_onedot(V, X):
    """K15c v3b_onedot (exp_spmm.py:173-196): v3's function as one
    (128, S b) product per tile."""
    if X.device.type == "cpu":
        return v3b_onedot_ref(V, X)
    Y = _stream(V, X, True)
    v3b_onedot.launches += 1
    return Y


def v4_gather(cols, X):
    """K15c v4_gather (exp_spmm.py:198-224): the gather alone, K15e's
    g0_slices kernel at width m."""
    if X.device.type == "cpu":
        return v4_gather_ref(cols, X)
    Y = gpr.gather_sum(cols, X)
    v4_gather.launches += 1
    return Y


KERNELS = (v1_panel_hi, v2_panel_def, v3_stream, v3b_onedot, v4_gather,
           v5_batched_hi, v5_batched_def, v6_smem_hi)
PLAIN = (v1_panel_hi_ref, v2_panel_def_ref, v3_stream_ref, v3b_onedot_ref,
         v4_gather_ref, v5_batched_hi_ref, v5_batched_def_ref,
         v6_smem_hi_ref)
# each wrapper's plain arithmetic, uncounted
PLAIN_OF = {v1_panel_hi: product_plain, v2_panel_def: product_def_plain,
            v3_stream: stream_plain, v3b_onedot: stream_plain,
            v4_gather: gpr.sum_plain, v5_batched_hi: product_plain,
            v5_batched_def: product_def_plain, v6_smem_hi: product_plain}


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
