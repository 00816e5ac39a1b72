"""Tap-stencil shifted-read probes (K15f): the CUDA kernel's wrapper and its
plain PyTorch version. No solver calls them; the probe script
maxwell_tpu_torch/bench/exp_stencil2.py does.

The probe of maxwell_tpu/bench/exp_stencil2.py: a padded f32 field F of
shape (NX + 2, Y + 2, ZM + 2m) (the tap stencil's (y, z * m) minor layout)
and an output O of shape (NX, Y, ZM),

    O[i, y, z] = sum over 33 taps t of c_t * F[i + 1 + dx, 1 + y + dy,
                                               m + z + dz * m]

with the taps of each case (CASES): p0 unshifted, p1 dz = +-1 (lane
shifts of m), p2 dy and dz, p3 three x-planes of 11 taps, p4 dy only; p5
is p1's function and p6 p3's, the reference's lane-rotate forms.

    shift_probe(case, field, m)        the kernel (csrc/stencil_probes.cu)
    shift_probe_ref(case, field, m)    its plain version: p0-p4 by slices,
                                       p5/p6 by torch.roll as the
                                       reference rolls (pltpu.roll)
    shift_plan(NX, Y, ZM, m, case, sms)  the kernel's launch on a card of
                                       sms SMs: the window of
                                       ty rows x tz lanes a block stages
                                       per plane, its chunk of x-planes,
                                       the threads, ring slots, shared
                                       memory and the bytes a launch
                                       stages; shift_windows(plan) lists
                                       each block's outputs;
                                       field_plan(case, field, m) the
                                       plan of a field on its card

Given CUDA tensors the wrapper checks them and launches the kernel or
raises; given CPU tensors it runs the plain version. Launches are counted
per case in `shift_probe.launches[case]`, plain calls in
`shift_probe_ref.calls[case]`; `shift_plain` is the plain arithmetic
without a count (the probe script's oracle).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

CASES = ("p0", "p1", "p2", "p3", "p4", "p5", "p6")
THREE_PLANES = ("p3", "p6")  # the cases that read planes x - 1, x, x + 1


def _taps(case):
    """[(dx, dy, dz, coefficient)] of the case's 33 taps, in the
    reference's order (exp_stencil2.py:35-60)."""
    if case not in CASES:
        raise ValueError(f"case must be one of {CASES}, got {case!r}")
    if case in ("p3", "p6"):
        return [(t - 1, (s // 3) % 3 - 1, s % 3 - 1, 1.0 + t + s)
                for t in range(3) for s in range(11)]

    def dy_dz(t):
        return {"p0": (0, 0), "p1": (0, t % 3 - 1),
                "p2": ((t // 3) % 3 - 1, t % 3 - 1), "p4": (t % 3 - 1, 0),
                "p5": (0, t % 3 - 1)}[case]

    return [(0, *dy_dz(t), 1.0 + t) for t in range(33)]


def shift_plain(case: str, field: torch.Tensor, m: int) -> torch.Tensor:
    """The case's output by shifted slices of the field (p0-p4) or, for
    p5/p6, by rolls of whole rows and planes, as the reference's bodies
    take them."""
    P, Yp, Lp = field.shape
    NX, Y, ZM = P - 2, Yp - 2, Lp - 2 * m
    acc = torch.zeros((NX, Y, ZM), dtype=field.dtype, device=field.device)
    if case in ("p5", "p6"):
        # roll(v, s)[j] = v[j - s]: a shift of +m reads dz = -1
        planes, dys = ((1,), (0,)) if case == "p5" else ((0, 1, 2),
                                                         (-1, 0, 1))
        view = {}
        for pl in planes:
            v = field[pl:pl + NX]
            for dz in (-1, 0, 1):
                vz = torch.roll(v, -dz * m, dims=2) if dz else v
                for dy in dys:
                    vy = torch.roll(vz, -dy, dims=1) if dy else vz
                    view[pl - 1, dy, dz] = vy[:, 1:1 + Y, m:m + ZM]
        for dx, dy, dz, c in _taps(case):
            acc = acc + c * view[dx, dy, dz]
        return acc
    for dx, dy, dz, c in _taps(case):
        acc = acc + c * field[1 + dx:1 + dx + NX, 1 + dy:1 + dy + Y,
                              m + dz * m:m + dz * m + ZM]
    return acc


def shift_probe_ref(case: str, field: torch.Tensor, m: int) -> torch.Tensor:
    """Plain version of shift_probe."""
    out = shift_plain(case, field, m)
    shift_probe_ref.calls[case] += 1
    return out


def _check(case, field, m) -> None:
    _taps(case)
    if field.dtype != torch.float32 or field.dim() != 3:
        raise ValueError(f"the field must be f32 (NX + 2, Y + 2, ZM + 2m), "
                         f"got {field.dtype} {tuple(field.shape)}")
    if not 1 <= m < 32:
        raise ValueError(f"m = {m} must lie in [1, 32) (p5/p6 shuffle by m "
                         f"lanes of a warp)")
    if min(field.shape[0], field.shape[1]) < 3 or field.shape[2] <= 2 * m:
        raise ValueError(f"the field {tuple(field.shape)} leaves no output "
                         f"at m = {m}")
    if field.numel() >= 2**31:
        raise ValueError("the kernel indexes the field with 32-bit ints")
    if not field.is_contiguous():
        raise ValueError("the field must be contiguous")


# the kernel's launch (csrc/stencil_probes.cu): a block owns ty output rows
# x tz lanes of a chunk of x-planes and stages each plane's window with its
# halo once in shared memory
MAX_THREADS = 256  # a block's threads, one output lane each (kMaxThreads)
TY_RANGE = range(4, 17)  # output rows of a window
MIN_SM_BLOCKS = 2  # blocks an SM at least, where the x extent allows
# the plan's int32 header, in the order the C entry point reads it
PLAN_FIELDS = ("NX", "Y", "ZM", "m", "ty", "tz", "chunk_x", "grid_z",
               "grid_y", "grid_x", "threads", "w", "slots", "smem_bytes",
               "vec")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ShiftPlan:
    """The shift kernel's launch (see shift_plan). Block b = (zb, yb, xb)
    (z fastest) computes output lanes zb tz .. + tz, rows yb ty .. + ty
    (clipped to the field) of planes xb NX // grid_x .. (xb + 1) NX //
    grid_x (chunk_x or chunk_x - 1 planes); per plane it stages field rows
    y0 .. y0 + ny + 1 and lanes z0 .. z0 + nz + 2m - 1 (its outputs' halo)
    in a ring slot of (ty + 2) rows of w floats."""

    NX: int
    Y: int
    ZM: int
    m: int
    case: str
    ty: int
    tz: int
    chunk_x: int  # the longest chunk of x-planes
    grid_z: int
    grid_y: int
    grid_x: int
    threads: int
    w: int  # floats of a staged row: tz + 2m, rounded up to 4
    slots: int  # ring slots: the planes an output reads, and the next one
    smem_bytes: int
    vec: int  # 1: 16-byte copies (row stride and window start aligned)
    staged_bytes: int  # what one launch copies into shared memory

    @property
    def blocks(self) -> int:
        return self.grid_z * self.grid_y * self.grid_x

    @property
    def field_bytes(self) -> int:
        return (self.NX + 2) * (self.Y + 2) * (self.ZM + 2 * self.m) * 4

    def header(self) -> np.ndarray:
        return np.array([getattr(self, f) for f in PLAN_FIELDS], np.int32)

    def summary(self) -> dict:
        """The launch as the probe records it: the window, chunk, grid,
        threads, ring slots, shared memory, copy unit, and the bytes a
        launch stages beside the field's (each field byte's first read: the
        rest is read again, from L2 where it holds)."""
        return {"ty": self.ty, "tz": self.tz, "chunk_x": self.chunk_x,
                "blocks": self.blocks, "threads": self.threads,
                "slots": self.slots, "smem": self.smem_bytes,
                "copy_bytes": 16 if self.vec else 4,
                "staged_bytes": self.staged_bytes,
                "field_bytes": self.field_bytes,
                "restaged_bytes": self.staged_bytes - self.field_bytes}


def shift_windows(plan: ShiftPlan):
    """(x0, x1, y0, y1, z0, z1) of each block's outputs, block order."""
    for b in range(plan.blocks):
        zb, rest = b % plan.grid_z, b // plan.grid_z
        yb, xb = rest % plan.grid_y, rest // plan.grid_y
        y0, z0 = yb * plan.ty, zb * plan.tz
        yield (xb * plan.NX // plan.grid_x, (xb + 1) * plan.NX // plan.grid_x,
               y0, min(y0 + plan.ty, plan.Y), z0, min(z0 + plan.tz, plan.ZM))


@functools.lru_cache(maxsize=64)
def shift_plan(NX: int, Y: int, ZM: int, m: int, case: str, sms: int,
               aligned: bool = True) -> ShiftPlan:
    """The shift kernel's launch for an (NX, Y, ZM) output at lane shift m
    on a card of `sms` SMs.

    Lanes: the fewest windows of at most MAX_THREADS lanes, evened out over
    ZM and rounded up to 4 (tz), one thread a lane. Rows: the ty in
    TY_RANGE (all Y rows if fewer) that stages the fewest rows per output
    row, ceil(Y / ty) (ty + 2); the larger ty on a tie. Ring: the planes a
    case reads (3 for p3/p6, else 1) and one more for the next plane's
    copy. x-planes: cut into grid_x near-equal chunks: of the cuts that
    give every SM two blocks at least (where NX allows), the one that
    gives the busiest SM the fewest staged window-planes, ceil(blocks /
    sms) blocks of the longest chunk and its halo planes (2 for p3/p6)
    each, and the fewest blocks on a tie (at 64^3 the balanced chunks of 3
    or 1 planes ran faster than the 2 that fill every resident place on
    the card once, and those of 6 slower). Rows are copied in 16-byte
    units where the field's row stride ZM + 2m is a multiple of 4 floats
    and its base is 16-byte aligned (`aligned`), else in 4-byte units.
    staged_bytes counts every window row a launch copies."""
    _taps(case)
    NX, Y, ZM, m, sms = int(NX), int(Y), int(ZM), int(m), int(sms)
    if min(NX, Y, ZM) < 1 or not 1 <= m < 32:
        raise ValueError(f"no launch for an ({NX}, {Y}, {ZM}) output at "
                         f"m = {m}")
    planes = 3 if case in THREE_PLANES else 1
    vec = int(bool(aligned) and (ZM + 2 * m) % 4 == 0)
    grid_z = _cdiv(ZM, MAX_THREADS)
    tz = _cdiv(_cdiv(ZM, grid_z), 4) * 4
    grid_z = _cdiv(ZM, tz)
    threads = _cdiv(tz, 32) * 32
    w = _cdiv(tz + 2 * m, 4) * 4
    if Y < TY_RANGE.start:
        ty = Y
    else:
        ty = min(TY_RANGE, key=lambda t: (_cdiv(Y, t) * (t + 2), -t))
    grid_y = _cdiv(Y, ty)
    slots = planes + 1
    smem = slots * (ty + 2) * w * 4  # at most 92 KB: 4 x 18 rows x 320
    tiles = grid_z * grid_y
    least = min(NX, _cdiv(MIN_SM_BLOCKS * sms, tiles))
    grid_x = min(range(least, NX + 1), key=lambda g: (
        _cdiv(tiles * g, sms) * (_cdiv(NX, g) + planes - 1), g))
    chunk_x = _cdiv(NX, grid_x)
    plan = ShiftPlan(NX, Y, ZM, m, case, ty, tz, chunk_x, grid_z, grid_y,
                     grid_x, threads, w, slots, smem, vec, 0)
    staged = 0
    for x0, x1, y0, y1, z0, z1 in shift_windows(plan):
        lanes = z1 - z0 + 2 * m
        row = 16 * _cdiv(lanes, 4) if vec else 4 * lanes
        staged += (x1 - x0 + planes - 1) * (y1 - y0 + 2) * row
    return dataclasses.replace(plan, staged_bytes=staged)


def field_plan(case: str, field: torch.Tensor, m: int) -> ShiftPlan:
    """shift_plan for a CUDA field (NX + 2, Y + 2, ZM + 2m) on its card."""
    P, Yp, Lp = field.shape
    sms = torch.cuda.get_device_properties(field.device).multi_processor_count
    return shift_plan(P - 2, Yp - 2, Lp - 2 * m, m, case, sms,
                      field.data_ptr() % 16 == 0)


def launch_shape(plan: ShiftPlan) -> dict:
    """The plan's launch on the current card: registers and local memory
    bytes a thread, resident blocks per SM (the occupancy API's count);
    see csrc/stencil_probes.cu shift_probe_shape. Needs the card."""
    import ctypes

    from maxwell_tpu_torch.kernels import _build

    out = (ctypes.c_int64 * 3)()
    rc = _build.load().shift_probe_shape(
        CASES.index(plan.case), plan.threads, plan.smem_bytes,
        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"shift_probe_shape: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), out))


def run_plan(plan: ShiftPlan, field: torch.Tensor, out: torch.Tensor):
    """The kernel's launch of `plan` (its case) on a checked field into
    out; raises on a CUDA error or a plan the kernel refuses."""
    from maxwell_tpu_torch.kernels import _build

    head = plan.header()
    lib = _build.load()
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream(field.device).cuda_stream
        # skew 0: keeps p1-p3's 33 tap reads 33 loads (csrc note)
        rc = lib.shift_probe_f32(field.data_ptr(), out.data_ptr(),
                                 CASES.index(plan.case), head.ctypes.data, 0,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"shift_probe {plan.case} launch failed: CUDA "
                           f"error {rc}")


def shift_probe(case: str, field: torch.Tensor, m: int) -> torch.Tensor:
    """K15f (exp_stencil2.py:120, bodies _mk :32-90): the case's 33-tap
    output of every x-plane, each plane's window staged once in shared
    memory (shift_plan)."""
    if field.device.type == "cpu":
        return shift_probe_ref(case, field, m)
    _check(case, field, m)
    plan = field_plan(case, field, m)
    out = torch.empty((plan.NX, plan.Y, plan.ZM), dtype=torch.float32,
                      device=field.device)
    run_plan(plan, field, out)
    shift_probe.launches[case] += 1
    return out


def reset_counts() -> None:
    """Zero the kernel's launch counts and the plain version's call counts
    of every case."""
    shift_probe.launches = dict.fromkeys(CASES, 0)
    shift_probe_ref.calls = dict.fromkeys(CASES, 0)


def counts() -> dict:
    """{shift_<case>: launches} and {shift_<case>_ref: calls}."""
    return {
        **{f"shift_{c}": n for c, n in shift_probe.launches.items()},
        **{f"shift_{c}_ref": n for c, n in shift_probe_ref.calls.items()},
    }


reset_counts()
