"""Tap-stencil apply of the 3D vacuum-PEC stencil pencil: the CUDA kernel's
wrapper and its plain PyTorch version.

    stencil_taps(X, mask, taps, shape, want_K, want_M) -> (YK | None, YM | None)

replaces `stencil_taps_pallas` of maxwell_tpu/kernels/stencil_taps.py (and
the XLA path `StencilPencil3D._taps_apply` it stands in for). X is the
stencil's flat (n_padded, m) block [Ex | Ey | Ez | pad] for the grid
shape = (nx, ny, nz); mask is the (n_padded,) PEC mask; taps is
`StencilPencil3D.taps`, per component a tuple of
(beta, (dx, dy, dz), cK, cM). The mask is applied to X before the taps and
to the outputs after them; padding rows come out zero.

Given CUDA tensors the wrapper checks them and launches the kernel
(csrc/stencil_taps.cu) or raises; `stencil_plan` is what the launch needs
from the host (the tile for m, the taps' offsets in the staged tile), and
the CPU tests apply it in torch. A launch takes at most MAX_PASS columns
(a staged row is at most two elements a thread); a wider X goes in
`column_passes`, each launch reading and writing its columns in place
through the row stride `ld`. Given CPU tensors it runs the plain
version `stencil_taps_ref`, which the CPU tests hold against the JAX package
and the chip smoke holds the kernel against. The wrapper counts its
launches (one a column pass) in `stencil_taps.launches`, the plain version
its calls in `stencil_taps_ref.calls`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def component_shapes(shape):
    """(X, Y, Z) of the Ex, Ey, Ez grids of an (nx, ny, nz) brick."""
    nx, ny, nz = shape
    return (
        (nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz)
    )


def to_grids(X: torch.Tensor, shape):
    """Views of the three component grids (X_a, Y_a, Z_a, m) of a flat
    (rows >= n, m) block."""
    m = X.shape[1]
    grids, start = [], 0
    for s in component_shapes(shape):
        size = s[0] * s[1] * s[2]
        grids.append(X[start : start + size].reshape(*s, m))
        start += size
    return grids


def from_grids(grids, n_padded: int) -> torch.Tensor:
    """Flat (n_padded, m) block of three component grids, zero padding."""
    m = grids[0].shape[-1]
    out = torch.cat([g.reshape(-1, m) for g in grids])
    return torch.nn.functional.pad(out, (0, 0, 0, n_padded - out.shape[0]))


def stencil_taps_ref(X, mask, taps, shape, want_K=True, want_M=False):
    """Plain version: each tap is a static slice of a zero-padded
    component grid, accumulated in tap order as the XLA path does."""
    stencil_taps_ref.calls += 1
    return taps_plain(X, mask, taps, shape, want_K, want_M)


def taps_plain(X, mask, taps, shape, want_K=True, want_M=False):
    """stencil_taps_ref's arithmetic without a count (a probe's oracle)."""
    mk = mask[:, None]
    grids = to_grids(X * mk, shape)
    # one zero plane on each side of every grid axis (not of m)
    P = [torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1, 1, 1)) for g in grids]
    outK, outM = [], []
    for alpha, s in enumerate(component_shapes(shape)):
        accK = X.new_zeros(tuple(s) + (X.shape[1],))
        accM = accK
        for beta, (dx, dy, dz), cK, cM in taps[alpha]:
            sl = P[beta][
                1 + dx : 1 + dx + s[0],
                1 + dy : 1 + dy + s[1],
                1 + dz : 1 + dz + s[2],
            ]
            if want_K and cK != 0.0:
                accK = accK + cK * sl
            if want_M and cM != 0.0:
                accM = accM + cM * sl
        outK.append(accK)
        outM.append(accM)
    n_padded = X.shape[0]
    return (
        from_grids(outK, n_padded) * mk if want_K else None,
        from_grids(outM, n_padded) * mk if want_M else None,
    )


# the kernel's tiling (csrc/stencil_taps.cu): a block owns TILE_Y x tile_z
# positions of the common (nx+1, ny+1, nz+1) box and a chunk of x-planes,
# and keeps RING x-planes of the three input components in shared memory
TILE_Y = 4  # output y rows per block (kTileY in the kernel)
RING = 3  # staged x-planes per input component: x - 1, x, x + 1
MAX_THREADS = 256  # a block's threads: one staged element of a row each
MAX_PASS = 2 * MAX_THREADS // 3  # columns of a launch: 3 m <= 2 MAX_THREADS
BLOCK_REGS = 80  # registers a thread (the kernel's launch bounds, 256 x 3)
SMS = 132  # the H100's streaming multiprocessors
SM_SMEM = 233472  # shared memory of an SM (228 KB), 1 KB of it per block
SM_THREADS = 2048
SM_REGS = 65536
MIN_CHUNK = 4  # x-planes of output per block at least (the halo costs 2)
WAVES = 2  # blocks to aim for: two waves of what fits on the card at once
# the plan's integer header, in the order the kernel reads it
PLAN_FIELDS = ("m", "n", "n_padded", "tile_y", "tile_z", "chunk_x", "grid_z",
               "grid_y", "grid_x", "pad_blocks", "threads", "row_stride",
               "plane", "smem_bytes", "ld")


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """What the tap kernel's launch needs from the host (see stencil_plan).

    Staged layout: for each of RING x-plane slots, for each input component
    beta, a plane of (TILE_Y + 2) rows of row_stride = (tile_z + 2) m
    floats: position (y0 - 1 + row, z0 - 1 + lz) of the tile, column j, at
    row * row_stride + lz * m + j; plane x lives in slot x mod RING. The
    taps come in columns (beta, dx, dz): column c's element for the output
    at (x, y0 + r, z0 + lz), column j, in staged row k is at
    slot(x + dx) * 3 plane + col_off[c] + k row_stride + (lz + 1) m + j,
    and its tap (alpha, dy) reads staged row r + 1 + dy."""

    m: int  # columns of the launch (its column pass)
    n: int
    n_padded: int
    ld: int  # row stride of X and the outputs, floats (m of one launch)
    dims: tuple  # (X, Y, Z) of the Ex, Ey, Ez grids
    offs: tuple  # first row of each component, then n
    box: tuple  # (X, Y, Z) extent of the common box of positions
    tile_y: int
    tile_z: int
    chunk_x: int  # x-planes of output per block
    grid_z: int
    grid_y: int
    grid_x: int
    pad_blocks: int  # blocks after the tiles that zero rows n .. n_padded
    threads: int
    row_stride: int
    plane: int
    smem_bytes: int
    columns: tuple  # (beta, dx, dz, first tap, tap count) of each column
    col_off: tuple  # beta plane + dz m: each column's offset in the tile
    taps: tuple  # (alpha, dy) of each tap, column by column
    coef: tuple  # (cK, cM) of each tap

    @property
    def tiles(self) -> int:
        return self.grid_z * self.grid_y * self.grid_x

    def header(self) -> np.ndarray:
        """The kernel's int32 plan: PLAN_FIELDS, the component dims (9), the
        component offsets (4), the box (3), the column and tap counts."""
        head = [getattr(self, f) for f in PLAN_FIELDS]
        return np.array(
            head + [d for dim in self.dims for d in dim] + list(self.offs)
            + list(self.box) + [len(self.columns), len(self.taps)], np.int32)

    def arrays(self):
        """(int32: each column's (beta, dx, dz, first, count, offset), then
        each tap's (alpha, dy); f32: each tap's (cK, cM))."""
        cols = [v for c, off in zip(self.columns, self.col_off)
                for v in (*c, off)]
        return (np.array(cols + [v for t in self.taps for v in t], np.int32),
                np.array(self.coef, np.float32).reshape(-1, 2))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(tile_z: int, m: int) -> int:
    """Shared memory of a block: RING planes of three components, each
    (TILE_Y + 2) rows of (tile_z + 2) m floats."""
    return RING * 3 * (TILE_Y + 2) * (tile_z + 2) * m * 4


def blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of the kernel an SM holds at once: by shared memory, threads
    and registers."""
    return min(SM_SMEM // (smem + 1024), SM_THREADS // threads,
               SM_REGS // (threads * BLOCK_REGS))


def column_passes(m: int) -> tuple:
    """(first column, width) of each launch for an X of m columns: the
    fewest passes of at most MAX_PASS columns, their widths as even as they
    can be (m 171: 86 + 85), since the tile's shape follows the width."""
    k = _cdiv(int(m), MAX_PASS)
    base, extra = divmod(int(m), k)
    out, j0 = [], 0
    for i in range(k):
        w = base + (i < extra)
        out.append((j0, w))
        j0 += w
    return tuple(out)


@functools.lru_cache(maxsize=32)
def stencil_plan(shape, m: int, taps, n_padded: int,
                 ld: int | None = None) -> StencilPlan:
    """The tap kernel's launch plan for an (nx, ny, nz) brick at width m,
    the columns of one launch, in rows of ld floats (m by default; the
    whole X's width when the launch is one of its column passes).

    Tiles: tile_z is the widest z extent whose staged row (tile_z + 2) m
    fits MAX_THREADS threads and whose block fits two to an SM's shared
    memory (at least 1), evened out over the box's z extent; TILE_Y rows;
    the box's x extent cut into chunks (of MIN_CHUNK planes at least) so
    that WAVES times as many blocks run as fit on the card at once. A
    staged row is at most two elements per thread. The taps go in columns
    (beta, dx, dz), each with its offset in the staged tile; dx picks the
    ring slot, a tap's dy its staged row. The kernel takes the vacuum hex
    element's pattern of 99 taps in 21 columns (csrc/stencil_taps.cu
    col_of, tap_of) and refuses another."""
    m = int(m)
    ld = m if ld is None else int(ld)
    if not 1 <= m <= MAX_PASS:
        raise ValueError(f"a tap kernel launch takes a staged row of 3 m <= "
                         f"{2 * MAX_THREADS} floats, got m = {m} (wider X "
                         f"goes in column_passes)")
    if ld < m:
        raise ValueError(f"row stride {ld} < m {m}")
    dims = tuple(tuple(d) for d in component_shapes(shape))
    sizes = [a * b * c for a, b, c in dims]
    offs = tuple(int(v) for v in np.cumsum([0] + sizes))
    n = offs[3]
    if n_padded < n:
        raise ValueError(f"n_padded {n_padded} < n {n}")
    box = tuple(max(d[i] for d in dims) for i in range(3))
    tz_max = max(1, MAX_THREADS // m - 2)
    while tz_max > 1 and smem_bytes(tz_max, m) + 1024 > SM_SMEM // 2:
        tz_max -= 1
    grid_z = _cdiv(box[2], tz_max)
    tile_z = _cdiv(box[2], grid_z)
    grid_z = _cdiv(box[2], tile_z)
    row_stride = (tile_z + 2) * m
    threads = min(_cdiv(row_stride, 32) * 32, MAX_THREADS)
    grid_y = _cdiv(box[1], TILE_Y)
    blocks = WAVES * SMS * blocks_per_sm(smem_bytes(tile_z, m), threads)
    grid_x = max(1, min(blocks // (grid_z * grid_y),
                        _cdiv(box[0], MIN_CHUNK)))
    chunk_x = _cdiv(box[0], grid_x)
    grid_x = _cdiv(box[0], chunk_x)
    plane = (TILE_Y + 2) * row_stride
    # the kernel's order: by column (beta, dx, dz), then (alpha, dy)
    flat = sorted(((a, b, *d, cK, cM) for a, comp in enumerate(taps)
                   for b, d, cK, cM in comp),
                  key=lambda t: (t[1], t[2], t[4], t[0], t[3]))
    if any(b not in (0, 1, 2) or any(abs(v) > 1 for v in d)
           for b, *d in (t[1:5] for t in flat)):
        raise ValueError("taps reach beta in 0..2, offsets in -1..1")
    columns, col_off = [], []
    for i, (_, b, dx, _, dz, _, _) in enumerate(flat):
        if not columns or columns[-1][:3] != (b, dx, dz):
            columns.append((b, dx, dz, i, 0))
            col_off.append(b * plane + dz * m)
        columns[-1] = (*columns[-1][:4], columns[-1][4] + 1)
    return StencilPlan(
        m=m, n=n, n_padded=int(n_padded), ld=ld, dims=dims, offs=offs,
        box=box,
        tile_y=TILE_Y, tile_z=tile_z, chunk_x=chunk_x, grid_z=grid_z,
        grid_y=grid_y, grid_x=grid_x,
        pad_blocks=_cdiv((n_padded - n) * m, threads), threads=threads,
        row_stride=row_stride, plane=plane,
        smem_bytes=smem_bytes(tile_z, m), columns=tuple(columns),
        col_off=tuple(col_off), taps=tuple((t[0], t[3]) for t in flat),
        coef=tuple((float(t[5]), float(t[6])) for t in flat))


def stencil_taps(X, mask, taps, shape, want_K=True, want_M=False, out=None):
    """(K @ X or None, M @ X or None) of the tap stencil, both (n_padded, m).
    On a CUDA device the kernel runs (f32 only), one launch per column pass
    of at most MAX_PASS columns; on the CPU the plain version. out: None, or
    (YK, YM) tensors shaped and typed like X (contiguous; None where not
    wanted) that the results are written into and returned as."""
    if not (want_K or want_M):
        raise ValueError("want_K or want_M must be set")
    if out is not None:
        for o, want in zip(out, (want_K, want_M)):
            if want and (o is None or o.shape != X.shape or o.dtype != X.dtype
                         or o.device != X.device or not o.is_contiguous()):
                raise ValueError(
                    "out must hold a contiguous tensor shaped and typed like "
                    f"X {tuple(X.shape)} {X.dtype} for each wanted output")
    if X.device.type == "cpu":
        Y = stencil_taps_ref(X, mask, taps, shape, want_K, want_M)
        if out is None:
            return Y
        return tuple(None if y is None else o.copy_(y)
                     for o, y in zip(out, Y))
    if X.dtype != torch.float32 or mask.dtype != torch.float32:
        raise ValueError(
            f"the stencil_taps kernel takes f32 X and mask, got {X.dtype} "
            f"and {mask.dtype}"
        )
    if X.dim() != 2 or X.shape[1] < 1 or not X.is_contiguous():
        raise ValueError(f"X must be contiguous (rows, m >= 1), got "
                         f"{tuple(X.shape)}")
    n = sum(a * b * c for a, b, c in component_shapes(shape))
    if mask.shape != (X.shape[0],) or X.shape[0] < n or not mask.is_contiguous():
        raise ValueError(
            f"mask {tuple(mask.shape)} and X {tuple(X.shape)} must have the "
            f"same n_padded >= n = {n}"
        )
    if X.numel() >= 2**31:
        raise ValueError(f"X {tuple(X.shape)} exceeds 32-bit indexing")
    if mask.device != X.device:
        raise ValueError(f"mask on {mask.device}, X on {X.device}")
    from maxwell_tpu_torch.kernels import _build

    m = X.shape[1]
    plans = [(j0, stencil_plan(tuple(shape), w, taps, X.shape[0], m))
             for j0, w in column_passes(m)]
    if out is None:
        out = tuple(torch.empty_like(X) if w else None
                    for w in (want_K, want_M))
    YK, YM = (o if w else None for o, w in zip(out, (want_K, want_M)))
    lib = _build.load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for j0, plan in plans:  # each pass in place: its columns, stride m
            head = plan.header()
            cols, coef = plan.arrays()
            rc = lib.stencil_taps_f32(
                X.data_ptr() + 4 * j0, mask.data_ptr(),
                YK.data_ptr() + 4 * j0 if want_K else None,
                YM.data_ptr() + 4 * j0 if want_M else None,
                head.ctypes.data, cols.ctypes.data, coef.ctypes.data, stream,
            )
            if rc != 0:
                raise RuntimeError(f"stencil_taps launch failed: error {rc}")
            stencil_taps.launches += 1
    return YK, YM


def reset_counts() -> None:
    """Zero the kernel's launch count and the plain version's call count."""
    stencil_taps.launches = 0
    stencil_taps_ref.calls = 0


def counts() -> dict:
    return {"stencil_taps": stencil_taps.launches,
            "stencil_taps_ref": stencil_taps_ref.calls}


reset_counts()
