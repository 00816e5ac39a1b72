"""The tap kernel's host plan (maxwell_tpu_torch/kernels/stencil_taps.py
`stencil_plan`: the tile for m, the ring of staged x-planes, each tap's
offset in the staged tile, the component extents), applied in torch the
way csrc/stencil_taps.cu applies it: block by block, x-planes of the three
input components staged masked and zero-padded into a flat ring, each
output read through the plan's offsets and masked. Held to the plain
version `stencil_taps_ref` and to the JAX `stencil_taps_pallas` in
interpret mode within 1e-5 of max|plain| (the bound the chip smoke holds
the kernel to; the sums run in another order), on an odd (7, 6, 5) grid
whose three component grids differ, at m 1, 9, 17 and 86 (86: several z
tiles, two staged elements a thread), for K, M and fused K/M, on PEC and
all-ones masks, with X random on masked and padding rows. Past 170
columns the wrapper launches in column passes (`column_passes`), each in
place through the row stride `ld`: the split and the passes applied one
by one are held the same way at m 171 and 256.
The kernel itself is tested on the card in test_torch_cuda.py."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.kernels.stencil_taps import stencil_taps_pallas
from maxwell_tpu.problems.stencil3d import StencilPencil3D as RefStencil3D
from maxwell_tpu_torch.kernels import stencil_taps as kst
from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D

torch.set_num_threads(1)

TOL = 1e-5  # chip_smoke.py's TOL["stencil"]
GRID = (7, 6, 5)
WIDTHS = (1, 9, 17, 86)
WIDE = (171, 256)  # two column passes each
MODES = {"K": (True, False), "M": (False, True), "KM": (True, True)}


def apply_plan(plan, X, mask, want_K, want_M, j0=0, acc_out=None):
    """(YK, YM, writes) as the kernel computes them under `plan`, for the
    launch whose first column is j0 of the (n_padded, plan.ld) block X;
    writes counts how often each output element was written. acc_out:
    (YK, YM, writes) flat buffers of an earlier pass to write into."""
    m, rs, P, ld = plan.m, plan.row_stride, plan.plane, plan.ld
    ty_rows = plan.tile_y + 2
    xf, mf = X.reshape(-1), mask
    if acc_out is None:
        outs = [torch.full((plan.n_padded * ld,), float("nan")) if w
                else None for w in (want_K, want_M)]
        writes = torch.zeros(plan.n_padded * ld, dtype=torch.int32)
    else:
        *outs, writes = acc_out
    e = torch.arange(rs)  # a staged row's elements
    o = torch.arange(plan.tile_z * m)  # an output row's elements
    r = torch.arange(plan.tile_y)[:, None]
    for b in range(plan.tiles):
        z0 = (b % plan.grid_z) * plan.tile_z
        y0 = (b // plan.grid_z % plan.grid_y) * plan.tile_y
        xb = b // (plan.grid_z * plan.grid_y) * plan.chunk_x
        xe = min(xb + plan.chunk_x, plan.box[0])
        ring = torch.full((kst.RING * 3 * P,), float("nan"))

        def stage(xp):
            slot = xp % kst.RING
            for beta, (Xb, Yb, Zb) in enumerate(plan.dims):
                for row in range(ty_rows):
                    y = y0 - 1 + row
                    z = z0 - 1 + e // m
                    ok = (0 <= xp < Xb and 0 <= y < Yb) & (z >= 0) & (z < Zb)
                    q = plan.offs[beta] + (xp * Yb + y) * Zb + z
                    q = torch.where(ok, q, 0)
                    val = torch.where(ok, xf[q * ld + j0 + e % m] * mf[q],
                                      0.0)
                    ring[slot * 3 * P + beta * P + row * rs + e] = val

        stage(xb - 1)
        stage(xb)
        for xc in range(xb, xe):
            stage(xc + 1)
            sb = [((xc - 1 + i) % kst.RING) * 3 * P for i in range(3)]
            k = torch.arange(ty_rows)[:, None]
            acc = torch.zeros((3, 2, plan.tile_y, o.numel()))
            for (_, dx, _, t0, nt), off in zip(plan.columns, plan.col_off):
                # the column's staged rows, each read once
                v = ring[sb[dx + 1] + off + k * rs + o + m]
                for (a, dy), cs in zip(plan.taps[t0:t0 + nt],
                                       plan.coef[t0:t0 + nt]):
                    rows_v = v[1 + dy: 1 + dy + plan.tile_y]
                    for op in range(2):
                        acc[a, op] = acc[a, op] + cs[op] * rows_v
            for A, (Xa, Ya, Za) in enumerate(plan.dims):
                z = z0 + o // m
                y = y0 + r
                ok = (z < Za) & (y < Ya) & (xc < Xa)
                rows = plan.offs[A] + (xc * Ya + y) * Za + z
                idx = (rows * ld + j0 + o % m)[ok]
                writes[idx] += 1
                for op, out in enumerate(outs):
                    if out is not None:
                        out[idx] = (acc[A, op] * mf[rows])[ok]
    pad_rows = torch.arange(plan.n, plan.n_padded)[:, None]
    pad = (pad_rows * ld + j0 + torch.arange(m)).reshape(-1)
    assert plan.pad_blocks * plan.threads >= pad.numel()
    writes[pad] += 1
    for out in outs:
        if out is not None:
            out[pad] = 0.0
    shaped = [None if y is None else y.reshape(plan.n_padded, ld)
              for y in outs]
    return shaped[0], shaped[1], writes


def apply_passes(port, X, mask, want_K, want_M):
    """The wrapper's launches on the (n_padded, m) block X: one plan per
    column pass, in rows of m floats, each applied in place."""
    m = X.shape[1]
    acc = None
    for j0, w in kst.column_passes(m):
        plan = kst.stencil_plan(port.shape, w, port.taps, port.n_padded, m)
        assert (plan.m, plan.ld) == (w, m)
        YK, YM, writes = apply_plan(plan, X, mask, want_K, want_M, j0, acc)
        acc = [None if y is None else y.reshape(-1) for y in (YK, YM)]
        acc.append(writes)
    return YK, YM, writes


@pytest.fixture(scope="module")
def setup():
    """{mask kind: (port pencil, mask, X at the widest m, JAX (K, M))}:
    the JAX interpret product is taken once per mask at the widest m (a
    column of the apply depends on that column of X alone)."""
    ref = RefStencil3D.build(nx=GRID[0], ny=GRID[1], nz=GRID[2], a=1.0,
                             b=0.8, c=1.3, dtype=jnp.float32)
    port = StencilPencil3D.build(nx=GRID[0], ny=GRID[1], nz=GRID[2], a=1.0,
                                 b=0.8, c=1.3, dtype=torch.float32,
                                 device="cpu")
    ones = np.zeros(port.n_padded, np.float32)
    ones[: port.n] = 1.0
    out = {}
    for kind, mask in (("pec", port.mask.numpy()), ("ones", ones)):
        # random on every row, masked and padding ones too
        wide = max(WIDE)
        X = np.random.default_rng(len(kind)).standard_normal(
            (port.n_padded, wide)).astype(np.float32)
        grids = ref._to_grids(jnp.asarray(X * mask[:, None]))
        got = stencil_taps_pallas(grids, ref.taps, wide, True, True,
                                  interpret=True)
        want = [np.asarray(ref._from_grids(*comp, wide))
                * mask[:, None] for comp in got]
        out[kind] = (port, torch.from_numpy(mask), X, want)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("mask_kind", ["pec", "ones"])
def test_plan_applied_matches_plain_and_pallas(setup, mask_kind, m, mode):
    port, mask, X, want_jax = setup[mask_kind]
    want_K, want_M = MODES[mode]
    plan = kst.stencil_plan(port.shape, m, port.taps, port.n_padded)
    # each block walks more than one x-plane, so the ring turns over
    assert plan.chunk_x > 1 and (plan.grid_z > 1) == (m == 86)
    Xm = torch.from_numpy(X[:, :m].copy())
    YK, YM, writes = apply_plan(plan, Xm, mask, want_K, want_M)
    # every output element written once, padding rows zero
    assert torch.equal(writes, torch.ones_like(writes))
    plain = kst.taps_plain(Xm, mask, port.taps, port.shape, want_K, want_M)
    for got, want, jax_want in zip((YK, YM), plain, want_jax):
        assert (got is None) == (want is None)
        if got is None:
            continue
        assert not got[port.n:].any()
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= TOL * scale
        jw = jax_want[:, :m]
        assert np.abs(got.numpy() - jw).max() <= TOL * np.abs(jw).max()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("m", WIDE)
@pytest.mark.parametrize("mask_kind", ["pec", "ones"])
def test_passes_applied_match_plain_and_pallas(setup, mask_kind, m, mode):
    """Past 170 columns: the wrapper's column passes applied one by one,
    each plan in rows of m floats reading and writing its own columns in
    place, against the plain version and the JAX kernel in interpret mode
    (1e-5 of max|plain|); every output element written once."""
    port, mask, X, want_jax = setup[mask_kind]
    want_K, want_M = MODES[mode]
    assert len(kst.column_passes(m)) == 2
    Xm = torch.from_numpy(X[:, :m].copy())
    YK, YM, writes = apply_passes(port, Xm, mask, want_K, want_M)
    assert torch.equal(writes, torch.ones_like(writes))
    plain = kst.taps_plain(Xm, mask, port.taps, port.shape, want_K, want_M)
    for got, want, jax_want in zip((YK, YM), plain, want_jax):
        assert (got is None) == (want is None)
        if got is None:
            continue
        assert got.shape == (port.n_padded, m) and not got[port.n:].any()
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= TOL * scale
        jw = jax_want[:, :m]
        assert np.abs(got.numpy() - jw).max() <= TOL * np.abs(jw).max()


@pytest.mark.parametrize("m", [1, 9, 170, 171, 256, 340, 341, 1000])
def test_column_passes_cover_every_column_once(m):
    """The split of X's m columns into launches: consecutive, every column
    once, none wider than 170, none narrower than half the widest (m 171
    is 86 + 85, not 170 + 1), one pass up to 170, the fewest passes past
    it; each pass's plan fits the kernel and keeps the whole X's stride."""
    passes = kst.column_passes(m)
    assert len(passes) == -(-m // kst.MAX_PASS) and kst.MAX_PASS == 170
    assert [j0 for j0, _ in passes] == list(
        np.cumsum([0] + [w for _, w in passes[:-1]]))
    assert sum(w for _, w in passes) == m
    widest = max(w for _, w in passes)
    assert widest <= 170 and 2 * min(w for _, w in passes) >= widest
    if m == 171:
        assert passes == ((0, 86), (86, 85))
    p = StencilPencil3D.build(nx=6, ny=5, nz=4, dtype=torch.float32,
                              device="cpu")
    for _, w in passes:
        plan = kst.stencil_plan(p.shape, w, p.taps, p.n_padded, m)
        assert plan.m == w and plan.ld == m
        assert plan.header()[kst.PLAN_FIELDS.index("ld")] == m
        assert plan.row_stride == (plan.tile_z + 2) * w <= 2 * plan.threads


def test_plan_at_the_solve_shape():
    """The 64^3 LOBPCG's fused apply at m 9: three z tiles of 22, 4-row
    tiles, one 224-thread block per tile and x-chunk of 5 planes, 46 KB of
    shared memory (three blocks to an SM, by the kernel's 80 registers a
    thread), 663 blocks: two waves on 132 SMs."""
    p = StencilPencil3D.build(nx=64, ny=64, nz=64, dtype=torch.float32,
                              device="cpu")
    plan = kst.stencil_plan(p.shape, 9, p.taps, p.n_padded)
    assert plan.box == (65, 65, 65)
    assert (plan.tile_y, plan.tile_z, plan.grid_z, plan.grid_y) == (4, 22, 3, 17)
    assert plan.threads == 224 and plan.row_stride == 216
    assert plan.smem_bytes == 3 * 3 * 6 * 216 * 4 == 46656
    assert kst.blocks_per_sm(plan.smem_bytes, plan.threads) == 3
    assert (plan.grid_x, plan.chunk_x, plan.tiles) == (13, 5, 663)
    # 99 taps, 33 per component, in 21 columns
    assert len(plan.taps) == 99 and len(plan.columns) == 21
    assert [sum(1 for a, _ in plan.taps if a == A) for A in range(3)] == [
        33, 33, 33]
    for (b, dx, dz, t0, nt), off in zip(plan.columns, plan.col_off):
        assert off == b * plan.plane + dz * 9


def test_plan_orders_taps_as_the_kernel_does():
    """The plan's columns and taps are the pattern the kernel has at
    compile time (csrc/stencil_taps.cu col_of, tap_of), for bricks of
    other shapes and cell aspect ratios too."""
    src = (Path(kst.__file__).parents[1] / "csrc" / "stencil_taps.cu"
           ).read_text()

    def table(fn):
        body = src[src.index(f"constexpr {fn}("):]
        body = body[body.index("= {") + 3: body.index("};")]
        return [tuple(int(v) for v in g.split(","))
                for g in re.findall(r"\{([-\d, ]+)\}", body)]

    cols, taps = table("Col col_of"), table("Tap tap_of")
    for dims, abc in ((GRID, (1.0, 0.8, 1.3)), ((64, 64, 64), (1, 1, 1)),
                      ((5, 9, 4), (2.0, 0.3, 1.7))):
        p = StencilPencil3D.build(nx=dims[0], ny=dims[1], nz=dims[2],
                                  a=abc[0], b=abc[1], c=abc[2],
                                  dtype=torch.float32, device="cpu")
        plan = kst.stencil_plan(p.shape, 9, p.taps, p.n_padded)
        assert [c for c in plan.columns] == cols
        assert [t for t in plan.taps] == taps
        head = plan.header()
        assert head[-2:].tolist() == [21, 99]


@pytest.mark.parametrize("m", [1, 2, 9, 17, 33, 85, 86, 100, 170])
def test_plan_fits_the_kernel(m):
    """What the kernel checks (csrc/stencil_taps.cu): a staged row is at
    most two elements per thread, at most 256 threads, and a block's
    shared memory fits the 227 KB a block can have (three blocks to an SM
    up to m 100)."""
    p = StencilPencil3D.build(nx=64, ny=64, nz=64, dtype=torch.float32,
                              device="cpu")
    plan = kst.stencil_plan(p.shape, m, p.taps, p.n_padded)
    assert plan.threads % 32 == 0 and plan.threads <= 256
    assert plan.row_stride == (plan.tile_z + 2) * m
    assert plan.tile_z * m <= plan.row_stride <= 2 * plan.threads
    assert plan.smem_bytes == kst.smem_bytes(plan.tile_z, m) <= 232448
    if m <= 100:
        assert kst.blocks_per_sm(plan.smem_bytes, plan.threads) >= 3
    assert plan.grid_z * plan.tile_z >= 65 > (plan.grid_z - 1) * plan.tile_z
    assert plan.grid_x * plan.chunk_x >= 65 > (plan.grid_x - 1) * plan.chunk_x
    head = plan.header()
    assert head[: len(kst.PLAN_FIELDS)].tolist() == [
        getattr(plan, f) for f in kst.PLAN_FIELDS]


def test_plan_refuses_what_the_kernel_does_not_take():
    """One launch takes at most 170 columns (the wrapper splits wider X
    into passes), a stride no narrower than its columns, all n rows."""
    p = StencilPencil3D.build(nx=6, ny=5, nz=4, dtype=torch.float32,
                              device="cpu")
    with pytest.raises(ValueError):
        kst.stencil_plan(p.shape, 171, p.taps, p.n_padded)
    with pytest.raises(ValueError):
        kst.stencil_plan(p.shape, 9, p.taps, p.n - 1)
    with pytest.raises(ValueError):
        kst.stencil_plan(p.shape, 9, p.taps, p.n_padded, 8)
