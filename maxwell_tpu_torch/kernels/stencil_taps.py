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
(csrc/stencil_taps.cu) or raises. Given CPU tensors it runs the plain
version `stencil_taps_ref`, which the CPU tests hold against the JAX package
and the chip smoke holds the kernel against. The wrapper counts its
launches in `stencil_taps.launches`, the plain version its calls in
`stencil_taps_ref.calls`.
"""

from __future__ import annotations

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


@functools.lru_cache(maxsize=16)
def tap_table(taps):
    """Host arrays of the kernel's tap table: meta (T, 4) int32 (beta, dx,
    dy, dz), coef (T, 2) f32 (cK, cM), counts (3,) int32; component 0's
    taps first."""
    meta = np.array(
        [(b, *d) for comp in taps for b, d, _, _ in comp], np.int32
    ).reshape(-1, 4)
    coef = np.array(
        [(cK, cM) for comp in taps for _, _, cK, cM in comp], np.float32
    ).reshape(-1, 2)
    counts = np.array([len(comp) for comp in taps], np.int32)
    return meta, coef, counts


def stencil_taps(X, mask, taps, shape, want_K=True, want_M=False):
    """(K @ X or None, M @ X or None) of the tap stencil, both (n_padded, m).
    On a CUDA device the kernel runs (f32 only); on the CPU the plain
    version."""
    if not (want_K or want_M):
        raise ValueError("want_K or want_M must be set")
    if X.device.type == "cpu":
        return stencil_taps_ref(X, mask, taps, shape, want_K, want_M)
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

    meta, coef, counts = tap_table(taps)
    dims = np.array(component_shapes(shape), np.int32)
    YK = torch.empty_like(X) if want_K else None
    YM = torch.empty_like(X) if want_M else None
    with torch.cuda.device(X.device):
        rc = _build.load().stencil_taps_f32(
            X.data_ptr(), mask.data_ptr(),
            YK.data_ptr() if want_K else None,
            YM.data_ptr() if want_M else None,
            meta.ctypes.data, coef.ctypes.data, counts.ctypes.data,
            dims.ctypes.data, X.shape[0], X.shape[1],
            torch.cuda.current_stream(X.device).cuda_stream,
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
