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

Given CUDA tensors the wrapper checks them and launches the kernel or
raises; given CPU tensors it runs the plain version. Launches are counted
per case in `shift_probe.launches[case]`, plain calls in
`shift_probe_ref.calls[case]`; `shift_plain` is the plain arithmetic
without a count (the probe script's oracle).
"""

from __future__ import annotations

import torch

CASES = ("p0", "p1", "p2", "p3", "p4", "p5", "p6")


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


def shift_probe(case: str, field: torch.Tensor, m: int) -> torch.Tensor:
    """K15f (exp_stencil2.py:120, bodies _mk :32-90): the case's 33-tap
    output of every x-plane, one thread per output element."""
    if field.device.type == "cpu":
        return shift_probe_ref(case, field, m)
    from maxwell_tpu_torch.kernels import _build

    _check(case, field, m)
    P, Yp, Lp = field.shape
    NX, Y, ZM = P - 2, Yp - 2, Lp - 2 * m
    out = torch.empty((NX, Y, ZM), dtype=torch.float32, device=field.device)
    lib = _build.load()
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream(field.device).cuda_stream
        # skew 0: keeps p1-p3's 33 tap reads 33 loads (csrc note)
        rc = lib.shift_probe_f32(field.data_ptr(), out.data_ptr(),
                                 CASES.index(case), NX, Y, ZM, m, 0, stream)
    if rc != 0:
        raise RuntimeError(f"shift_probe {case} launch failed: CUDA error "
                           f"{rc}")
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
