"""Exact spectral solve of (K + alpha*M) W = R for vacuum-PEC brick
cavities on the stencil's flat layout: the LOBPCG preconditioner of the
matrix-free path, and the per-column shift solve of the on-device
refinement. The port of maxwell_tpu/solvers/spectral.py (single device).

Math. On a uniform tensor grid the lowest-order Nedelec pencil
diagonalizes in a mixed sine/cosine tensor basis: per axis, let
(An, Mn) be the interior-node 1D stiffness/mass pair with Mn-orthonormal
generalized eigenvectors s_k (discrete sines), eigenvalues lam_k, and let
u_k = D s_k / sqrt(lam_k) (discrete cosines on cells, Mc-orthonormal,
Mc = h*I), plus u_0 = const. Component bases:

    Ex: u(kx) (x) s(ky) (x) s(kz),   Ey: s (x) u (x) s,   Ez: s (x) s (x) u

With sig_k = sqrt(lam_k) (sig_0 = 0), the transformed pencil per mode
triple is M^ = I, K^ = |sig|^2 I - sig sig^T, so with
beta = alpha + |sig|^2, Sherman-Morrison gives

    (K^ + alpha I)^-1 = I/beta + sig sig^T / (alpha * beta).

The solve is: forward axis transforms (dense contractions), two elementwise
grids, inverse transforms. The transforms are plain torch.einsum, run in
true f32 (no TF32: `fp32_true`), as the reference runs them under
Precision.HIGHEST outside any kernel. For loaded PEC cavities the vacuum
solve is an approximate preconditioner.

DistSpectralShift is the same solve on the slab-sharded stencil pencil
(dist/stencil_dist.py) in its stacked view: the y/z transforms are local to
each slab, and the x transform's global contraction is the sum, in slab
order, of each slab's ownership-weighted partial (the reference's psum).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from maxwell_tpu_torch.utils.precision import fp32_true


def _axis_1d(n: int, h: float):
    """Interior-node sine basis + cell cosine basis for one axis.

    Returns (S (n-1, n-1), U (n, n), sig (n,)): S columns Mn-orthonormal,
    U columns Mc-orthonormal, sig[k] = sqrt(lam_k) with sig[0] = 0 (the
    constant cell mode pairs with no sine)."""
    import scipy.linalg

    q = n - 1
    Mn = (h / 6.0) * (
        4.0 * np.eye(q) + np.eye(q, k=1) + np.eye(q, k=-1)
    )
    An = (1.0 / h) * (
        2.0 * np.eye(q) - np.eye(q, k=1) - np.eye(q, k=-1)
    )
    lam, S = scipy.linalg.eigh(An, Mn)  # S^T Mn S = I
    # cell derivative of interior hats: (D phi)_c = (phi_{c+1}-phi_c)/h
    D = np.zeros((n, q))
    for c in range(n):
        if c < q:
            D[c, c] = 1.0 / h  # node c+1 = interior index c
        if c - 1 >= 0:
            D[c, c - 1] = -1.0 / h
    sig = np.sqrt(lam)
    U = np.zeros((n, n))
    U[:, 0] = 1.0 / np.sqrt(n * h)
    U[:, 1:] = (D @ S) / sig[None, :]
    return S, U, np.concatenate([[0.0], sig])


@dataclasses.dataclass(frozen=True)
class SpectralShiftSolver:
    """W = (K + alpha*M)^-1 R on the stencil flat layout (vacuum PEC)."""

    Sx: torch.Tensor
    Sy: torch.Tensor
    Sz: torch.Tensor
    Ux: torch.Tensor
    Uy: torch.Tensor
    Uz: torch.Tensor
    sigx: torch.Tensor  # (nx,) etc., sig[0] = 0
    sigy: torch.Tensor
    sigz: torch.Tensor
    alpha: float
    nx: int
    ny: int
    nz: int
    n: int
    n_padded: int

    @staticmethod
    def build(a, b, c, nx, ny, nz, alpha, n_padded,
              dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cuda") -> "SpectralShiftSolver":
        hx, hy, hz = a / nx, b / ny, c / nz
        Sx, Ux, sigx = _axis_1d(nx, hx)
        Sy, Uy, sigy = _axis_1d(ny, hy)
        Sz, Uz, sigz = _axis_1d(nz, hz)
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return SpectralShiftSolver(
            Sx=t(Sx), Sy=t(Sy), Sz=t(Sz), Ux=t(Ux), Uy=t(Uy), Uz=t(Uz),
            sigx=t(sigx), sigy=t(sigy), sigz=t(sigz),
            alpha=float(alpha), nx=nx, ny=ny, nz=nz,
            n=nx * (ny + 1) * (nz + 1) + (nx + 1) * ny * (nz + 1)
            + (nx + 1) * (ny + 1) * nz,
            n_padded=n_padded,
        )

    @staticmethod
    def from_reference(
        obj, device: str | torch.device = "cuda"
    ) -> "SpectralShiftSolver":
        """Carry a JAX SpectralShiftSolver over (arrays through
        np.asarray)."""
        t = lambda v: torch.from_numpy(np.array(v)).to(device)
        return SpectralShiftSolver(
            *(t(getattr(obj, k)) for k in (
                "Sx", "Sy", "Sz", "Ux", "Uy", "Uz", "sigx", "sigy", "sigz")),
            alpha=float(obj.alpha), nx=int(obj.nx), ny=int(obj.ny),
            nz=int(obj.nz), n=int(obj.n), n_padded=int(obj.n_padded),
        )

    # ------------------------------------------------------------------
    def _grids(self, X):
        nx, ny, nz = self.nx, self.ny, self.nz
        m = X.shape[1]
        sx = nx * (ny + 1) * (nz + 1)
        sy = (nx + 1) * ny * (nz + 1)
        Ex = X[:sx].reshape(nx, ny + 1, nz + 1, m)
        Ey = X[sx : sx + sy].reshape(nx + 1, ny, nz + 1, m)
        Ez = X[sx + sy : self.n].reshape(nx + 1, ny + 1, nz, m)
        return Ex, Ey, Ez

    @staticmethod
    def _tr3(G, Ax, Ay, Az):
        """Contract grid (X, Y, Z, m) with per-axis transform matrices:
        out[k,l,p,m] = sum A_x[i,k] A_y[j,l] A_z[q,p] G[i,j,q,m]."""
        G = torch.einsum("ik,ijqm->kjqm", Ax, G)
        G = torch.einsum("jl,kjqm->klqm", Ay, G)
        return torch.einsum("qp,klqm->klpm", Az, G)

    def solve(self, R: torch.Tensor) -> torch.Tensor:
        """(K + alpha M)^-1 R, R (n_padded, m) flat stencil layout.
        Rows outside the PEC-interior tensor structure (masked boundary
        edges, padding) pass through as zeros."""
        return self._solve_alpha(R, self.alpha)

    def solve_sigma(self, R: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """(K - sigma_j M)^-1 R[:, j] per column: the exact shift-invert
        solve at per-column shifts (sigma (m,) must avoid the symbol
        eigenvalues |sig|^2)."""
        return self._solve_alpha(R, -sigma[None, None, None, :])

    @fp32_true
    def _solve_alpha(self, R: torch.Tensor, alpha) -> torch.Tensor:
        vec = R.dim() == 1
        Rl = R[:, None] if vec else R
        m = Rl.shape[1]
        nx, ny, nz = self.nx, self.ny, self.nz
        Ex, Ey, Ez = self._grids(Rl)
        # interior tensor blocks (PEC: tangential boundary rows are masked)
        ex = Ex[:, 1:ny, 1:nz]  # (nx, ny-1, nz-1, m)
        ey = Ey[1:nx, :, 1:nz]
        ez = Ez[1:nx, 1:ny, :]

        # forward: r^ = P^T r (_tr3 contracts A[i,k] over the grid axis i)
        rx = self._tr3(ex, self.Ux, self.Sy, self.Sz)
        ry = self._tr3(ey, self.Sx, self.Uy, self.Sz)
        rz = self._tr3(ez, self.Sx, self.Sy, self.Uz)

        # mode lattice (nx, ny, nz): position 0 on each SINE axis is absent
        # -> zero padding; sig vectors already carry sig[0] = 0
        pad = lambda g, px, py, pz: torch.nn.functional.pad(
            g, (0, 0, pz, 0, py, 0, px, 0)
        )
        Rx = pad(rx, 0, 1, 1)
        Ry = pad(ry, 1, 0, 1)
        Rz = pad(rz, 1, 1, 0)
        sx_ = self.sigx[:, None, None, None]
        sy_ = self.sigy[None, :, None, None]
        sz_ = self.sigz[None, None, :, None]
        beta = alpha + sx_**2 + sy_**2 + sz_**2
        dot = sx_ * Rx + sy_ * Ry + sz_ * Rz
        coef = dot / (alpha * beta)
        Hx = Rx / beta + sx_ * coef
        Hy = Ry / beta + sy_ * coef
        Hz = Rz / beta + sz_ * coef

        # inverse: w = P h (contract the COLUMN index => pass A^T to _tr3)
        wx = self._tr3(Hx[:, 1:, 1:], self.Ux.T, self.Sy.T, self.Sz.T)
        wy = self._tr3(Hy[1:, :, 1:], self.Sx.T, self.Uy.T, self.Sz.T)
        wz = self._tr3(Hz[1:, 1:, :], self.Sx.T, self.Sy.T, self.Uz.T)

        Yx, Yy, Yz = (torch.zeros_like(g) for g in (Ex, Ey, Ez))
        Yx[:, 1:ny, 1:nz] = wx
        Yy[1:nx, :, 1:nz] = wy
        Yz[1:nx, 1:ny, :] = wz
        out = torch.cat(
            [Yx.reshape(-1, m), Yy.reshape(-1, m), Yz.reshape(-1, m)]
        )
        out = torch.nn.functional.pad(out, (0, 0, 0, self.n_padded - self.n))
        return out[:, 0] if vec else out


# --- slab transforms: grids (D, X, Y, Z, m), one per slab --------------------
def x_rows(A_full: torch.Tensor, rows: int, step: int, count: int,
           first: int = 0):
    """(count, rows, k) view of slabs first .. first + count - 1's rows of
    a replicated 1D transform: slab d's rows d step .. d step + rows - 1
    (the reference's dynamic_slice)."""
    return A_full.unfold(0, rows, step)[first:first + count].transpose(1, 2)


def tr_yz(G, Ay, Az):
    """Each slab's y and z contractions: out[d, i, l, p, m] =
    sum A_y[j, l] A_z[q, p] G[d, i, j, q, m]."""
    G = torch.einsum("jl,dijqm->dilqm", Ay, G)
    return torch.einsum("qp,dilqm->dilpm", Az, G)


def tr_x_parts(G, Axl):
    """Each slab's partial of the global x contraction: out[d] =
    sum_i Axl[d, i, k] G[d, i] (their slab-order sum is the psum)."""
    return torch.einsum("dik,dijqm->dkjqm", Axl, G)


def tr_x_local(H, Axl):
    """The inverse x transform onto each slab's planes: out[d, r] =
    sum_k Axl[d, r, k] H[k] (H replicated over the slabs)."""
    return torch.einsum("drk,kjqm->drjqm", Axl, H)


@dataclasses.dataclass(frozen=True)
class DistSpectralShift:
    """(K + alpha M)^-1 for the slab-sharded vacuum PEC stencil pencil
    (dist/stencil_dist.DistStencilPencil3D): the distributed LOBPCG
    preconditioner and the distributed refinement's shift solve.

    The y/z transforms are local to each slab. The x transform is a global
    contraction: each slab contracts its own x-planes (ownership-weighted,
    so a replicated interface plane counts once) against its rows of the
    replicated 1D matrices, and the D partial mode grids are summed in
    slab order (across processes gathered from every rank first, the three
    components' in one gather); the inverse transform back to each slab's
    planes is then local, and the two copies of an interface plane agree by
    construction. Each slab here applies its y/z transforms to its own
    planes before the x contraction, the reference after it: the same
    linear map, with D times fewer y/z products in the stacked view.

    Sx_full, Sy_full, Sz_full: the sine matrices with zero rows at the
    Dirichlet boundary nodes, so a slab's rows are a plain slice."""

    Sx_full: torch.Tensor  # (nx+1, nx-1)
    Sy_full: torch.Tensor  # (ny+1, ny-1)
    Sz_full: torch.Tensor  # (nz+1, nz-1)
    Ux: torch.Tensor  # (nx, nx)
    Uy: torch.Tensor
    Uz: torch.Tensor
    sigx: torch.Tensor
    sigy: torch.Tensor
    sigz: torch.Tensor
    alpha: float
    nx: int
    ny: int
    nz: int
    cells: int

    @staticmethod
    def build(sp, alpha: float, dtype: torch.dtype | None = None):
        """From a DistStencilPencil3D, vacuum only (materials raise
        ValueError); another pencil raises AttributeError, as the
        reference's build does on an assembled DistPencil (it has no
        materials fields)."""
        from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D

        if not isinstance(sp, DistStencilPencil3D):
            raise AttributeError(
                f"{type(sp).__name__} is not a slab-sharded stencil pencil "
                f"(no inv_mu/eps): the distributed spectral solve needs a "
                f"DistStencilPencil3D")
        if sp.inv_mu is not None or sp.eps is not None:
            raise ValueError("distributed spectral solve is vacuum-only")
        hx, hy, hz = sp.ax / sp.nx, sp.by / sp.ny, sp.cz / sp.nz
        Sx, Ux, sigx = _axis_1d(sp.nx, hx)
        Sy, Uy, sigy = _axis_1d(sp.ny, hy)
        Sz, Uz, sigz = _axis_1d(sp.nz, hz)

        def full(S, n):
            F = np.zeros((n + 1, n - 1))
            F[1:n] = S
            return F

        t = lambda v: torch.as_tensor(v, dtype=dtype or sp.dtype,
                                      device=sp.device)
        return DistSpectralShift(
            Sx_full=t(full(Sx, sp.nx)), Sy_full=t(full(Sy, sp.ny)),
            Sz_full=t(full(Sz, sp.nz)), Ux=t(Ux), Uy=t(Uy), Uz=t(Uz),
            sigx=t(sigx), sigy=t(sigy), sigz=t(sigz),
            alpha=float(alpha), nx=sp.nx, ny=sp.ny, nz=sp.nz,
            cells=sp.cells,
        )

    def solve(self, sp, R: torch.Tensor) -> torch.Tensor:
        """(K + alpha M)^-1 R on the stacked layout, R (Dl n_loc_pad[, m])
        (a collective across processes)."""
        return self._solve_alpha(sp, R, self.alpha)

    def solve_sigma(self, sp, R: torch.Tensor,
                    sigma: torch.Tensor) -> torch.Tensor:
        """(K - sigma_j M)^-1 R[:, j] per column on the stacked layout: the
        distributed refinement's inner solve."""
        return self._solve_alpha(sp, R, -sigma[None, None, None, :])

    @fp32_true
    def _solve_alpha(self, sp, R: torch.Tensor, alpha) -> torch.Tensor:
        vec = R.dim() == 1
        Rl = R[:, None] if vec else R
        c, ny, nz, Dl = self.cells, self.ny, self.nz, sp.Dl
        mk = sp.mask.to(Rl.dtype)
        # ownership-weighted so the slab sum counts interface planes once
        ex, ey, ez = sp._to_grids(Rl * (mk * sp.w_dot.to(Rl.dtype))[:, None])
        Uxl = x_rows(self.Ux, c, c, Dl, sp.d0)  # (Dl, c, nx)
        Sxl = x_rows(self.Sx_full, c + 1, c, Dl, sp.d0)  # (Dl, c+1, nx-1)
        Syi = self.Sy_full[1:ny]  # interior rows (ny-1, ny-1)
        Szi = self.Sz_full[1:nz]
        # forward: interior y/z slices and transforms per slab, then the
        # x contraction summed over the slabs: replicated mode grids
        rx, ry, rz = sp._sum_slabs(
            tr_x_parts(tr_yz(ex[:, :, 1:ny, 1:nz], Syi, Szi), Uxl),
            tr_x_parts(tr_yz(ey[:, :, :, 1:nz], self.Uy, Szi), Sxl),
            tr_x_parts(tr_yz(ez[:, :, 1:ny, :], Syi, self.Uz), Sxl))

        pad = lambda g, px, py, pz: torch.nn.functional.pad(
            g, (0, 0, pz, 0, py, 0, px, 0))
        Rx = pad(rx, 0, 1, 1)
        Ry = pad(ry, 1, 0, 1)
        Rz = pad(rz, 1, 1, 0)
        sx_ = self.sigx[:, None, None, None]
        sy_ = self.sigy[None, :, None, None]
        sz_ = self.sigz[None, None, :, None]
        beta = alpha + sx_**2 + sy_**2 + sz_**2
        dot = sx_ * Rx + sy_ * Ry + sz_ * Rz
        coef = dot / (alpha * beta)
        Hx = (Rx / beta + sx_ * coef)[:, 1:, 1:]
        Hy = (Ry / beta + sy_ * coef)[1:, :, 1:]
        Hz = (Rz / beta + sz_ * coef)[1:, 1:, :]

        # inverse: each slab's planes from the replicated mode grids
        wx = tr_yz(tr_x_local(Hx, Uxl), Syi.T, Szi.T)
        wy = tr_yz(tr_x_local(Hy, Sxl), self.Uy.T, Szi.T)
        wz = tr_yz(tr_x_local(Hz, Sxl), Syi.T, self.Uz.T)
        P = torch.nn.functional.pad
        out = sp._from_grids(P(wx, (0, 0, 1, 1, 1, 1)), P(wy, (0, 0, 1, 1)),
                             P(wz, (0, 0, 0, 0, 1, 1)))
        out = out * mk[:, None]
        return out[:, 0] if vec else out


def spectral_preconditioner(pencil, alpha: float = 15.0):
    """(K + alpha M)^-1 preconditioner for a PEC StencilPencil3D.

    Exact for the vacuum pencil (tap path). For loaded PEC cavities
    (eps_r/mu_r != 1, field-coefficient taps) the vacuum solve serves as an
    approximate preconditioner. PMC pencils are rejected: the interior-sine
    tensor basis encodes PEC walls."""
    if (
        getattr(pencil, "nz", None) is None
        or getattr(pencil, "bc", "pec") != "pec"
        or (
            getattr(pencil, "taps", None) is None
            and getattr(pencil, "ftaps_meta", None) is None
        )
    ):
        raise ValueError(
            "spectral preconditioner needs a 3D PEC tap/ftap pencil"
        )
    sol = SpectralShiftSolver.build(
        pencil.a, pencil.b, pencil.c, pencil.nx, pencil.ny, pencil.nz,
        alpha, pencil.n_padded, dtype=pencil.dtype, device=pencil.device,
    )
    return functools.partial(_spectral_apply, sol)


def _spectral_apply(sol: SpectralShiftSolver, R: torch.Tensor) -> torch.Tensor:
    return sol.solve(R)
