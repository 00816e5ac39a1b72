"""Assembly-free curl-curl/mass apply for the 3D brick cavity: the port of
maxwell_tpu/problems/stencil3d.py.

Edge fields live on their natural grids: Ex (nx, ny+1, nz+1),
Ey (nx+1, ny, nz+1), Ez (nx+1, ny+1, nz). No matrix is stored. A vacuum PEC
pencil applies K and M by a translation-invariant tap stencil (~33 taps per
component): on a CUDA device through the hand-written kernel
(kernels/stencil_taps.py, csrc/stencil_taps.cu), on the CPU through its
plain version. Loaded cavities and PMC walls use field-coefficient taps
(one coefficient grid per tap), and `KM_mm_dw` applies both operators in
double-word f32 arithmetic for the on-device refinement to 1e-8
(solvers/refine_device.py); those two are plain torch, as the reference
writes them in jnp.

The host derivations (_LOCAL_EDGES, _derive_taps, _derive_taps_dw,
_derive_field_taps) are numpy copies of the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from maxwell_tpu_torch.kernels.stencil_taps import (
    from_grids,
    stencil_taps,
    to_grids,
)
from maxwell_tpu_torch.solvers.cg import cg
from maxwell_tpu_torch.solvers.deflation import GradientProjector


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


# Local edge table for the hex element (matches the panel order in
# _element_apply_multi / problems.cavity3d.hex_element_matrices):
# (component, cell-relative offset): locals 0-3 are x-edges at (0, b, g),
# 4-7 y-edges at (a, 0, g), 8-11 z-edges at (a, b, 0) for a,b,g in {0,1}.
_LOCAL_EDGES = (
    (0, (0, 0, 0)), (0, (0, 1, 0)), (0, (0, 0, 1)), (0, (0, 1, 1)),
    (1, (0, 0, 0)), (1, (1, 0, 0)), (1, (0, 0, 1)), (1, (1, 0, 1)),
    (2, (0, 0, 0)), (2, (1, 0, 0)), (2, (0, 1, 0)), (2, (1, 1, 0)),
)


def _derive_taps(Ke, Me):
    """Collapse the per-cell (12x12) element apply into a translation-
    invariant tap stencil (gather form).

    For output edge p of component alpha, each element pair (a, b) with
    comp(a)=alpha contributes E[a,b] * X_{comp(b)}[p + (o_b - o_a)] from the
    cell at p - o_a.  Grouping by (beta, delta) is exact on every UNMASKED
    PEC row: a row is unmasked iff all its adjacent cells exist, so every
    grouped pair's cell is valid there; masked rows are zeroed afterwards
    anyway.  (PMC keeps boundary rows live -> fast path disabled there.)

    Returns: tuple over alpha in (x,y,z) of tuples
    (beta, (dx,dy,dz), coefK, coefM), taps with both coefficients zero
    dropped.  ~33 taps per component (matches the assembled row nnz).
    """
    taps = []
    for alpha in range(3):
        acc = {}
        for a, (ca, oa) in enumerate(_LOCAL_EDGES):
            if ca != alpha:
                continue
            for b, (cb, ob) in enumerate(_LOCAL_EDGES):
                d = (ob[0] - oa[0], ob[1] - oa[1], ob[2] - oa[2])
                k = (cb, d)
                cK, cM = acc.get(k, (0.0, 0.0))
                acc[k] = (cK + float(Ke[a, b]), cM + float(Me[a, b]))
        taps.append(
            tuple(
                (beta, d, cK, cM)
                for (beta, d), (cK, cM) in sorted(acc.items())
                if cK != 0.0 or cM != 0.0
            )
        )
    return tuple(taps)


def _derive_taps_dw(Ke64, Me64):
    """Double-word tap coefficients from the FULL-f64 element matrices:
    each tap coefficient c is carried as an (hi, lo) f32 pair with
    hi + lo == c to f64 accuracy (the f32-cast taps alone would floor the
    double-word apply at ~1e-7 relative operator error)."""
    taps64 = _derive_taps(np.asarray(Ke64, np.float64),
                          np.asarray(Me64, np.float64))

    def split(c):
        hi = np.float32(c)
        return float(hi), float(np.float32(c - float(hi)))

    out = []
    for comp in taps64:
        entries = []
        for beta, d, cK, cM in comp:
            entries.append((beta, d, split(cK), split(cM)))
        out.append(tuple(entries))
    return tuple(out)


def _derive_field_taps(Ke, Me, nx, ny, nz, scaleK, scaleM, dtype=None,
                       dw=False):
    """Position-dependent tap stencil for LOADED cavities and PMC walls.

    Same grouping as _derive_taps, but each (alpha, beta, delta) tap carries
    a coefficient GRID instead of a scalar:

        C[p] = sum over element pairs (a, b) of E[a,b] * scale[p - o_a]

    with the per-cell scale grid (1/mu_r for K, eps_r for M) ZERO-padded
    outside the domain. The zero padding makes the formula exact on EVERY
    row — including PMC boundary rows whose element sum only runs over the
    cells that exist — so one mechanism covers materials, PMC, and their
    combination.

    Returns (meta, Kgrids, Mgrids, Kdw, Mdw): meta = tuple over alpha of
    tuples (beta, (dx,dy,dz), iK, iM) with iK/iM indices into the flat
    grid lists (or -1 when that operator has no such tap). Grids are numpy
    arrays accumulated in f64 and cast to `dtype` (default: Ke's dtype).
    With dw=True, Kdw/Mdw are ((hi...), (lo...)) f32 pair tuples carrying
    the f64-accurate coefficients for the double-word apply; else None.
    """
    Ke = np.asarray(Ke, np.float64)
    Me = np.asarray(Me, np.float64)
    np_dt = np.dtype(dtype) if dtype is not None else Ke.dtype
    shapes = (
        (nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz)
    )
    padK = np.zeros((nx + 2, ny + 2, nz + 2), dtype=np.float64)
    padK[1:-1, 1:-1, 1:-1] = scaleK
    padM = np.zeros_like(padK)
    padM[1:-1, 1:-1, 1:-1] = scaleM
    meta, Kgrids, Mgrids = [], [], []
    Khi, Klo, Mhi, Mlo = [], [], [], []

    def _dw_split(g):
        hi = g.astype(np.float32)
        return hi, (g - hi.astype(np.float64)).astype(np.float32)
    for alpha in range(3):
        s = shapes[alpha]
        acc = {}
        for a, (ca, oa) in enumerate(_LOCAL_EDGES):
            if ca != alpha:
                continue
            # scale grid of the cell p - o_a, as an array over edge index p
            win = tuple(
                slice(1 - oa[ax], 1 - oa[ax] + s[ax]) for ax in range(3)
            )
            sK = padK[win]
            sM = padM[win]
            for b_, (cb, ob) in enumerate(_LOCAL_EDGES):
                d = (ob[0] - oa[0], ob[1] - oa[1], ob[2] - oa[2])
                k = (cb, d)
                cK, cM = acc.get(k, (0.0, 0.0))
                acc[k] = (
                    cK + float(Ke[a, b_]) * sK,
                    cM + float(Me[a, b_]) * sM,
                )
        entries = []
        for (beta, d), (cK, cM) in sorted(acc.items()):
            hasK = np.any(np.asarray(cK) != 0.0)
            hasM = np.any(np.asarray(cM) != 0.0)
            if not hasK and not hasM:
                continue
            iK = iM = -1
            if hasK:
                iK = len(Kgrids)
                Kgrids.append(np.asarray(cK).astype(np_dt))
                if dw:
                    h, l = _dw_split(np.asarray(cK, np.float64))
                    Khi.append(h)
                    Klo.append(l)
            if hasM:
                iM = len(Mgrids)
                Mgrids.append(np.asarray(cM).astype(np_dt))
                if dw:
                    h, l = _dw_split(np.asarray(cM, np.float64))
                    Mhi.append(h)
                    Mlo.append(l)
            entries.append((beta, d, iK, iM))
        meta.append(tuple(entries))
    Kdw = (tuple(Khi), tuple(Klo)) if dw else None
    Mdw = (tuple(Mhi), tuple(Mlo)) if dw else None
    return tuple(meta), tuple(Kgrids), tuple(Mgrids), Kdw, Mdw


def _window(P, s, d):
    """The (s)-shaped window of a once-padded grid P shifted by d."""
    dx, dy, dz = d
    return P[1 + dx : 1 + dx + s[0], 1 + dy : 1 + dy + s[1],
             1 + dz : 1 + dz + s[2]]


def _pad_grids(grids):
    """One zero plane on each side of every grid axis (not of m)."""
    return [torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1, 1, 1))
            for g in grids]


@dataclasses.dataclass(frozen=True)
class StencilPencil3D:
    """Matrix-free 3D pencil on the FULL edge set (PEC via masking).

    Flat layout: [Ex (nx, ny+1, nz+1) | Ey (nx+1, ny, nz+1) |
    Ez (nx+1, ny+1, nz)], each row-major, then pad. Tensors live on the
    pencil's device (the mask's).
    """

    mask: torch.Tensor
    Ke: torch.Tensor  # (12, 12)
    Me: torch.Tensor
    proj: GradientProjector | None
    a: float
    b: float
    c: float
    nx: int
    ny: int
    nz: int
    n: int
    n_padded: int
    mass_tol: float = 1e-12
    mass_iters: int = 300
    # optional per-cell materials (nx, ny, nz): curl (1/mu_r) curl E =
    # k^2 eps_r E
    inv_mu: torch.Tensor | None = None
    eps: torch.Tensor | None = None
    # exact tensor-product nodal solver (vacuum PEC only)
    fastproj: "object | None" = None
    # translation-invariant tap stencil (vacuum PEC only; _derive_taps)
    taps: tuple | None = None
    # field-coefficient taps (materials / PMC; _derive_field_taps): static
    # structure and per-tap coefficient grids
    ftaps_meta: tuple | None = None
    ftaps_K: tuple | None = None
    ftaps_M: tuple | None = None
    # double-word (hi, lo f32) tap coefficients (_derive_taps_dw / KM_mm_dw)
    taps_dw: tuple | None = None
    # double-word field-coefficient grids ((hi...), (lo...))
    ftaps_Kdw: tuple | None = None
    ftaps_Mdw: tuple | None = None
    # boundary condition ("pec" | "pmc"): the spectral solver's interior
    # sine/cosine basis is valid for PEC only
    bc: str = "pec"

    @property
    def dtype(self) -> torch.dtype:
        return self.mask.dtype

    @property
    def device(self) -> torch.device:
        return self.mask.device

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)

    # --- reductions -------------------------------------------------------
    def weigh(self, x):
        return x

    def dot_mm(self, A, B):
        return A.T @ B

    def dot_cols(self, A, B):
        return torch.sum(A * B, dim=0)

    def dot_vv(self, x, y):
        return torch.dot(x, y)

    def dot_basis(self, V, w):
        return V @ w

    def col_norms(self, A):
        return torch.sqrt(torch.clamp(self.dot_cols(A, A), min=0.0))

    # --- packing ----------------------------------------------------------
    def _to_grids(self, X):
        return to_grids(X, self.shape)

    def _from_grids(self, Ex, Ey, Ez):
        return from_grids((Ex, Ey, Ez), self.n_padded)

    # --- the element apply (shared by K and M) ----------------------------
    def _element_apply_multi(self, E, X, scales=None):
        """Y_j = A_j X for each stacked (12x12) element matrix (E is
        (12k, 12)); one panel gather serves all k operators. scales: tuple
        of per-cell (nx, ny, nz) material coefficients (or None) per output.
        Returns (k, n_padded, m)."""
        Xl = X * self.mask[:, None]
        nx, ny, nz = self.shape
        k = E.shape[0] // 12
        if scales is None:
            scales = (None,) * k
        Ex, Ey, Ez = self._to_grids(Xl)
        panels = [
            Ex[:, 0:ny, 0:nz], Ex[:, 1 : ny + 1, 0:nz],
            Ex[:, 0:ny, 1 : nz + 1], Ex[:, 1 : ny + 1, 1 : nz + 1],
            Ey[0:nx, :, 0:nz], Ey[1 : nx + 1, :, 0:nz],
            Ey[0:nx, :, 1 : nz + 1], Ey[1 : nx + 1, :, 1 : nz + 1],
            Ez[0:nx, 0:ny, :], Ez[1 : nx + 1, 0:ny, :],
            Ez[0:nx, 1 : ny + 1, :], Ez[1 : nx + 1, 1 : ny + 1, :],
        ]
        G = torch.stack(panels)  # (12, nx, ny, nz, m)
        Y = torch.einsum("ab,bxyzm->axyzm", E, G)
        outs = []
        for j in range(k):
            Yj = Y[12 * j : 12 * (j + 1)]
            if scales[j] is not None:
                Yj = Yj * scales[j][None, :, :, :, None]
            Yx, Yy, Yz = (torch.zeros_like(g) for g in (Ex, Ey, Ez))
            Yx[:, 0:ny, 0:nz] += Yj[0]
            Yx[:, 1 : ny + 1, 0:nz] += Yj[1]
            Yx[:, 0:ny, 1 : nz + 1] += Yj[2]
            Yx[:, 1 : ny + 1, 1 : nz + 1] += Yj[3]
            Yy[0:nx, :, 0:nz] += Yj[4]
            Yy[1 : nx + 1, :, 0:nz] += Yj[5]
            Yy[0:nx, :, 1 : nz + 1] += Yj[6]
            Yy[1 : nx + 1, :, 1 : nz + 1] += Yj[7]
            Yz[0:nx, 0:ny, :] += Yj[8]
            Yz[1 : nx + 1, 0:ny, :] += Yj[9]
            Yz[0:nx, 1 : ny + 1, :] += Yj[10]
            Yz[1 : nx + 1, 1 : ny + 1, :] += Yj[11]
            outs.append(self._from_grids(Yx, Yy, Yz) * self.mask[:, None])
        return torch.stack(outs)

    def _element_apply(self, E, X, scale=None):
        vec = X.dim() == 1
        Xl = X[:, None] if vec else X
        out = self._element_apply_multi(E, Xl, scales=(scale,))[0]
        return out[:, 0] if vec else out

    # --- the tap stencil (vacuum PEC) -------------------------------------
    def _taps_apply(self, X, want_K, want_M):
        """(YK or None, YM or None) by the tap stencil: the CUDA kernel on a
        CUDA device, its plain version on the CPU."""
        vec = X.dim() == 1
        Xl = (X[:, None] if vec else X).contiguous()
        out = stencil_taps(Xl, self.mask, self.taps, self.shape,
                           want_K=want_K, want_M=want_M)
        return tuple(
            None if Y is None else (Y[:, 0] if vec else Y) for Y in out
        )

    # --- double-word tap apply (on-device 1e-8 path) -----------------------
    def KM_mm_dw(self, Xh, Xl, want_K=True, want_M=True):
        """(K @ X, M @ X) in DOUBLE-WORD f32 arithmetic: X carried as the
        unevaluated pair Xh + Xl, tap coefficients as f64-accurate (hi, lo)
        pairs, accumulation by error-free transforms (utils/twofloat); the
        apply is accurate to ~1e-13 relative. Same shifted-slice structure
        as the plain tap apply, in eager torch (see utils/twofloat on why it
        is not fused).

        Returns ((YKh, YKl) or None, (YMh, YMl) or None)."""
        from maxwell_tpu_torch.utils import twofloat as tf

        if self.taps_dw is None and self.ftaps_Kdw is None:
            raise ValueError("KM_mm_dw needs a tap or field-tap pencil")
        mk = self.mask[:, None]
        Xh = Xh * mk
        Xl = Xl * mk  # mask is 0/1: exact on both words
        m = Xh.shape[1]
        Ph = _pad_grids(self._to_grids(Xh))
        Pl = _pad_grids(self._to_grids(Xl))
        outK, outM = [], []
        for alpha in range(3):
            s = tuple(Ph[alpha].shape[i] - 2 for i in range(3))
            z = Xh.new_zeros(s + (m,))
            aKh, aKl, aMh, aMl = z, z, z, z
            if self.taps_dw is not None:
                # coefficient pairs as 0-d device tensors: a Python float
                # would make two_prod split it in f64
                tab = torch.tensor(
                    [(*cK, *cM) for _, _, cK, cM in self.taps_dw[alpha]],
                    dtype=Xh.dtype,
                ).to(Xh.device)
                for t, (beta, d, cK, cM) in enumerate(self.taps_dw[alpha]):
                    sh, sl = _window(Ph[beta], s, d), _window(Pl[beta], s, d)
                    if want_K and (cK[0] != 0.0 or cK[1] != 0.0):
                        th, tl = tf.dw_mul(sh, sl, tab[t, 0], tab[t, 1])
                        aKh, aKl = tf.dw_add(aKh, aKl, th, tl)
                    if want_M and (cM[0] != 0.0 or cM[1] != 0.0):
                        th, tl = tf.dw_mul(sh, sl, tab[t, 2], tab[t, 3])
                        aMh, aMl = tf.dw_add(aMh, aMl, th, tl)
            else:
                # field-coefficient dw taps (loaded cavities / PMC): the
                # coefficient is a grid pair broadcast over the m axis
                Khi, Klo = self.ftaps_Kdw
                Mhi, Mlo = self.ftaps_Mdw
                for beta, d, iK, iM in self.ftaps_meta[alpha]:
                    sh, sl = _window(Ph[beta], s, d), _window(Pl[beta], s, d)
                    if want_K and iK >= 0:
                        th, tl = tf.dw_mul(
                            sh, sl, Khi[iK][..., None], Klo[iK][..., None]
                        )
                        aKh, aKl = tf.dw_add(aKh, aKl, th, tl)
                    if want_M and iM >= 0:
                        th, tl = tf.dw_mul(
                            sh, sl, Mhi[iM][..., None], Mlo[iM][..., None]
                        )
                        aMh, aMl = tf.dw_add(aMh, aMl, th, tl)
            outK.append((aKh, aKl))
            outM.append((aMh, aMl))

        def pack(pairs):
            return (
                self._from_grids(*(p[0] for p in pairs)) * mk,
                self._from_grids(*(p[1] for p in pairs)) * mk,
            )

        return (
            pack(outK) if want_K else None,
            pack(outM) if want_M else None,
        )

    # --- field-coefficient taps (materials / PMC) --------------------------
    def _ftaps_apply(self, X, want_K, want_M):
        """Shifted-slice apply with position-dependent tap coefficients
        (_derive_field_taps): exact for per-cell eps/mu and on PMC boundary
        rows. Each tap multiplies its window by its coefficient grid."""
        vec = X.dim() == 1
        Xl = (X[:, None] if vec else X) * self.mask[:, None]
        P = _pad_grids(self._to_grids(Xl))
        outK, outM = [], []
        for alpha in range(3):
            s = tuple(P[alpha].shape[i] - 2 for i in range(3))
            accK = Xl.new_zeros(s + (Xl.shape[1],))
            accM = accK
            for beta, d, iK, iM in self.ftaps_meta[alpha]:
                sl = _window(P[beta], s, d)
                if want_K and iK >= 0:
                    accK = accK + self.ftaps_K[iK][..., None] * sl
                if want_M and iM >= 0:
                    accM = accM + self.ftaps_M[iM][..., None] * sl
            outK.append(accK)
            outM.append(accM)

        def pack(Ys):
            out = self._from_grids(*Ys) * self.mask[:, None]
            return out[:, 0] if vec else out

        return (
            pack(outK) if want_K else None,
            pack(outM) if want_M else None,
        )

    def K_mm(self, X):
        if self.taps is not None:
            return self._taps_apply(X, True, False)[0]
        if self.ftaps_meta is not None:
            return self._ftaps_apply(X, True, False)[0]
        return self._element_apply(self.Ke, X, scale=self.inv_mu)

    def M_mm(self, X):
        if self.taps is not None:
            return self._taps_apply(X, False, True)[1]
        if self.ftaps_meta is not None:
            return self._ftaps_apply(X, False, True)[1]
        return self._element_apply(self.Me, X, scale=self.eps)

    def KM_mm(self, X):
        if self.taps is not None:
            # fused taps: each shifted input is read once for K and M
            return self._taps_apply(X, True, True)
        if self.ftaps_meta is not None:
            return self._ftaps_apply(X, True, True)
        # fused: one panel gather + one (24x12) contraction for K and M
        vec = X.dim() == 1
        Xl = X[:, None] if vec else X
        E2 = torch.cat([self.Ke, self.Me], dim=0)
        Y2 = self._element_apply_multi(E2, Xl, scales=(self.inv_mu, self.eps))
        if vec:
            return Y2[0][:, 0], Y2[1][:, 0]
        return Y2[0], Y2[1]

    def Minv_mm(self, X):
        return cg(
            self.M_mm, X, tol=self.mass_tol, maxiter=self.mass_iters,
            dot=self.dot_cols,
        )

    # --- grid-form discrete gradient ---------------------------------------
    # On the tensor grid G is a finite-difference operator: static slices
    # instead of the projector's head/tail and incidence gathers.
    def _g_grid(self, q):
        """(n_padded, m) <- G q for q ((nx-1)(ny-1)(nz-1), m) interior
        nodal values (row-major), PEC edge mask applied."""
        nx, ny, nz = self.shape
        hx, hy, hz = self.a / nx, self.b / ny, self.c / nz
        m = q.shape[1]
        phin = q.new_zeros((nx + 1, ny + 1, nz + 1, m))
        phin[1:nx, 1:ny, 1:nz] = q.reshape(nx - 1, ny - 1, nz - 1, m)
        Ex = (phin[1:] - phin[:-1]) / hx
        Ey = (phin[:, 1:] - phin[:, :-1]) / hy
        Ez = (phin[:, :, 1:] - phin[:, :, :-1]) / hz
        return self._from_grids(Ex, Ey, Ez) * self.mask[:, None]

    def _gt_grid(self, Y):
        """((nx-1)(ny-1)(nz-1), m) <- G^T Y over interior nodes."""
        nx, ny, nz = self.shape
        hx, hy, hz = self.a / nx, self.b / ny, self.c / nz
        Ex, Ey, Ez = self._to_grids(Y * self.mask[:, None])
        acc = (Ex[:-1, 1:ny, 1:nz] - Ex[1:, 1:ny, 1:nz]) / hx
        acc = acc + (Ey[1:nx, :-1, 1:nz] - Ey[1:nx, 1:, 1:nz]) / hy
        acc = acc + (Ez[1:nx, 1:ny, :-1] - Ez[1:nx, 1:ny, 1:]) / hz
        return acc.reshape(-1, Y.shape[1])

    def project(self, X):
        """Mask the PEC dims and remove the gradient component."""
        Xm = X * (self.mask if X.dim() == 1 else self.mask[:, None])
        if self.proj is None:
            return Xm
        if self.fastproj is not None:
            vec = Xm.dim() == 1
            Xl = Xm[:, None] if vec else Xm
            rhs = self._gt_grid(self.M_mm(Xl))
            q = self.fastproj.solve(rhs)
            out = Xl - self._g_grid(q)
            return out[:, 0] if vec else out
        return self.proj.project(self.M_mm, Xm)

    # --- construction -----------------------------------------------------
    @staticmethod
    def build(
        a=1.0, b=1.0, c=1.0, nx=8, ny=8, nz=8,
        dtype: torch.dtype = torch.float32, block: int = 8,
        eps_r=None, mu_r=None, bc: str = "pec",
        device: str | torch.device = "cuda",
    ) -> "StencilPencil3D":
        import scipy.sparse as sp

        from maxwell_tpu_torch.problems.cavity3d import hex_element_matrices

        np_dt = numpy_dtype(dtype)
        hx, hy, hz = a / nx, b / ny, c / nz
        Ke, Me = hex_element_matrices(hx, hy, hz)

        sx = nx * (ny + 1) * (nz + 1)
        sy = (nx + 1) * ny * (nz + 1)
        sz = (nx + 1) * (ny + 1) * nz
        n = sx + sy + sz
        n_padded = _round_up(n, block * max(128 // block, 1))

        # masks (PEC: tangential edges on walls removed)
        mask = np.zeros(n_padded, dtype=np_dt)
        xi, xj, xk = np.meshgrid(
            np.arange(nx), np.arange(ny + 1), np.arange(nz + 1), indexing="ij"
        )
        mask[:sx] = (
            ((xj != 0) & (xj != ny) & (xk != 0) & (xk != nz))
            if bc == "pec"
            else np.ones_like(xj, bool)
        ).reshape(-1)
        yi, yj, yk = np.meshgrid(
            np.arange(nx + 1), np.arange(ny), np.arange(nz + 1), indexing="ij"
        )
        mask[sx : sx + sy] = (
            ((yi != 0) & (yi != nx) & (yk != 0) & (yk != nz))
            if bc == "pec"
            else np.ones_like(yi, bool)
        ).reshape(-1)
        zi, zj, zk = np.meshgrid(
            np.arange(nx + 1), np.arange(ny + 1), np.arange(nz), indexing="ij"
        )
        mask[sx + sy : n] = (
            ((zi != 0) & (zi != nx) & (zj != 0) & (zj != ny))
            if bc == "pec"
            else np.ones_like(zi, bool)
        ).reshape(-1)

        # discrete gradient (interior nodes), stencil layout, masked rows
        def node(i, j, k):
            return (i * (ny + 1) + j) * (nz + 1) + k

        rows, cols, vals = [], [], []
        eid_x = ((xi * (ny + 1) + xj) * (nz + 1) + xk).reshape(-1)
        for head, sgn in (
            (node(xi + 1, xj, xk), 1.0 / hx),
            (node(xi, xj, xk), -1.0 / hx),
        ):
            rows.append(eid_x)
            cols.append(head.reshape(-1))
            vals.append(np.full(eid_x.size, sgn))
        eid_y = sx + ((yi * ny + yj) * (nz + 1) + yk).reshape(-1)
        for head, sgn in (
            (node(yi, yj + 1, yk), 1.0 / hy),
            (node(yi, yj, yk), -1.0 / hy),
        ):
            rows.append(eid_y)
            cols.append(head.reshape(-1))
            vals.append(np.full(eid_y.size, sgn))
        eid_z = sx + sy + ((zi * (ny + 1) + zj) * nz + zk).reshape(-1)
        for head, sgn in (
            (node(zi, zj, zk + 1), 1.0 / hz),
            (node(zi, zj, zk), -1.0 / hz),
        ):
            rows.append(eid_z)
            cols.append(head.reshape(-1))
            vals.append(np.full(eid_z.size, sgn))

        n_nodes = (nx + 1) * (ny + 1) * (nz + 1)
        G_full = sp.coo_matrix(
            (
                np.concatenate(vals),
                (np.concatenate(rows), np.concatenate(cols)),
            ),
            shape=(n, n_nodes),
        ).tocsr()
        G_full = sp.diags(mask[:n].astype(float)) @ G_full
        ni, nj, nk = np.meshgrid(
            np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1),
            indexing="ij",
        )
        ni, nj, nk = ni.reshape(-1), nj.reshape(-1), nk.reshape(-1)
        if bc == "pec":
            interior = (
                (ni > 0) & (ni < nx) & (nj > 0) & (nj < ny)
                & (nk > 0) & (nk < nz)
            )
        else:
            # natural BC: the gradient nullspace spans ALL nodal hats modulo
            # the constant — ground node 0 (matches stencil2d)
            interior = node(ni, nj, nk) != 0
        G = G_full[:, node(ni, nj, nk)[interior]]
        proj = GradientProjector.from_gradient(
            G.tocsr(), n_padded, dtype=dtype, device=device
        )

        fastproj = None
        if eps_r is None and bc == "pec":
            # the tensor-product fast solve assumes Dirichlet interior nodes
            from maxwell_tpu_torch.solvers.fast_poisson import FastPoisson3D

            fastproj = FastPoisson3D.build(
                a, b, c, nx, ny, nz, dtype=dtype, device=device
            )
        # tap stencil: exact only when every unmasked row has all adjacent
        # cells valid (PEC) and coefficients are cell-independent. The taps
        # come from the dtype-CAST element matrices, so the tap and panel
        # paths agree at the working dtype, not only at f64.
        taps = (
            _derive_taps(np.asarray(Ke, np_dt), np.asarray(Me, np_dt))
            if (eps_r is None and mu_r is None and bc == "pec")
            else None
        )
        # f64-accurate double-word taps for the on-device 1e-8 path
        taps_dw = _derive_taps_dw(Ke, Me) if taps is not None else None
        ftaps_meta = ftaps_K = ftaps_M = None
        ftaps_Kdw = ftaps_Mdw = None
        t = lambda v, dt=dtype: torch.as_tensor(v, dtype=dt, device=device)
        if taps is None:
            ones = np.ones((nx, ny, nz), np.float64)
            sK = (
                ones if mu_r is None
                else 1.0 / np.asarray(mu_r, np.float64)
            )
            sM = ones if eps_r is None else np.asarray(eps_r, np.float64)
            (
                ftaps_meta, Kg, Mg, Kdw, Mdw,
            ) = _derive_field_taps(
                Ke, Me, nx, ny, nz, sK, sM, dtype=np_dt, dw=True,
            )
            ftaps_K = tuple(t(g) for g in Kg)
            ftaps_M = tuple(t(g) for g in Mg)
            f32 = lambda pair: tuple(
                tuple(t(g, torch.float32) for g in gs) for gs in pair
            )
            ftaps_Kdw, ftaps_Mdw = f32(Kdw), f32(Mdw)
        return StencilPencil3D(
            mask=t(mask),
            Ke=t(Ke),
            Me=t(Me),
            proj=proj,
            a=a, b=b, c=c, nx=nx, ny=ny, nz=nz, n=n, n_padded=n_padded,
            inv_mu=None if mu_r is None else t(1.0 / np.asarray(mu_r)),
            eps=None if eps_r is None else t(eps_r),
            fastproj=fastproj,
            taps=taps,
            taps_dw=taps_dw,
            ftaps_meta=ftaps_meta, ftaps_K=ftaps_K, ftaps_M=ftaps_M,
            ftaps_Kdw=ftaps_Kdw, ftaps_Mdw=ftaps_Mdw,
            bc=bc,
        )

    @staticmethod
    def from_reference(
        obj, device: str | torch.device = "cuda"
    ) -> "StencilPencil3D":
        """Carry a JAX StencilPencil3D (or any object with the same fields)
        over: mask, element matrices, materials, the tap tuples, the dw
        taps, the field-tap grids and the projector; every array is read
        through np.asarray. The reference's `taps_impl` has no counterpart:
        a tap pencil on a CUDA device always applies through the kernel."""
        from maxwell_tpu_torch.solvers.fast_poisson import FastPoisson3D

        t = lambda v: torch.from_numpy(np.array(v)).to(device)
        opt = lambda v: None if v is None else t(v)
        grids = lambda gs: None if gs is None else tuple(t(g) for g in gs)
        pairs = lambda p: None if p is None else tuple(grids(g) for g in p)
        proj = obj.proj
        return StencilPencil3D(
            mask=t(obj.mask), Ke=t(obj.Ke), Me=t(obj.Me),
            proj=None if proj is None else GradientProjector.from_reference(
                proj, device),
            a=float(obj.a), b=float(obj.b), c=float(obj.c),
            nx=int(obj.nx), ny=int(obj.ny), nz=int(obj.nz),
            n=int(obj.n), n_padded=int(obj.n_padded),
            mass_tol=float(obj.mass_tol), mass_iters=int(obj.mass_iters),
            inv_mu=opt(obj.inv_mu), eps=opt(obj.eps),
            fastproj=None if obj.fastproj is None
            else FastPoisson3D.from_reference(obj.fastproj, device),
            taps=obj.taps, taps_dw=obj.taps_dw,
            ftaps_meta=obj.ftaps_meta, ftaps_K=grids(obj.ftaps_K),
            ftaps_M=grids(obj.ftaps_M), ftaps_Kdw=pairs(obj.ftaps_Kdw),
            ftaps_Mdw=pairs(obj.ftaps_Mdw), bc=obj.bc,
        )
