"""Assembly-free (matrix-free) curl-curl/mass apply for the 2D tensor-grid
cavity: the port of maxwell_tpu/problems/stencil2d.py, in plain torch (the
reference writes it in jnp; it has no Pallas kernel).

Edge fields live on their natural grids (Ex on (nx, ny+1), Ey on
(nx+1, ny)); per-cell element matrices act through static slices and
shifted adds. PEC is enforced by masking boundary-tangential edges to zero
after every apply. The applies reproduce the assembled K/M of RectCavity2D
(same element integrals) to machine precision.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from maxwell_tpu_torch.problems.stencil3d import numpy_dtype
from maxwell_tpu_torch.solvers.cg import cg
from maxwell_tpu_torch.solvers.deflation import GradientProjector


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class StencilPencil2D:
    """Matrix-free pencil on the FULL edge set of an nx x ny rectangle grid.

    Flat layout: [Ex row-major (nx, ny+1) | Ey row-major (nx+1, ny) | pad].
    Implements the same operator protocol as solvers.operator.Pencil.
    """

    mask: torch.Tensor  # (n_padded,) 1.0 on interior-tangential edges
    proj: GradientProjector | None
    a: float
    b: float
    nx: int
    ny: int
    n: int
    n_padded: int
    mass_tol: float = 1e-12
    mass_iters: int = 300
    # optional per-cell materials (nx, ny)
    inv_mu: torch.Tensor | None = None
    eps: torch.Tensor | None = None
    # exact tensor-product nodal solver (vacuum only)
    fastproj: "object | None" = None

    @property
    def dtype(self) -> torch.dtype:
        return self.mask.dtype

    @property
    def device(self) -> torch.device:
        return self.mask.device

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

    # --- grid packing -----------------------------------------------------
    @property
    def _nxe(self):
        return self.nx * (self.ny + 1)

    def _to_grids(self, X):
        """(n_padded, m) -> Ex (nx, ny+1, m), Ey (nx+1, ny, m)."""
        m = X.shape[1]
        Ex = X[: self._nxe].reshape(self.nx, self.ny + 1, m)
        Ey = X[self._nxe : self.n].reshape(self.nx + 1, self.ny, m)
        return Ex, Ey

    def _from_grids(self, Ex, Ey, m):
        out = torch.cat([Ex.reshape(-1, m), Ey.reshape(-1, m)])
        return torch.nn.functional.pad(out, (0, 0, 0, self.n_padded - self.n))

    # --- applies ----------------------------------------------------------
    def K_mm(self, X):
        """Curl-curl apply: K_e = area * c c^T per cell; the per-cell scalar
        u = c^T x_cell is the discrete curl, scattered back with weights
        area * c."""
        vec = X.dim() == 1
        Xl = (X[:, None] if vec else X) * self.mask[:, None]
        m = Xl.shape[1]
        hx, hy = self.a / self.nx, self.b / self.ny
        area = hx * hy
        Ex, Ey = self._to_grids(Xl)
        # cell curl u (nx, ny, m); c = (1/hy, -1/hy, -1/hx, 1/hx) for
        # (bottom, top, left, right)
        u = (Ex[:, :-1] - Ex[:, 1:]) / hy + (Ey[1:, :] - Ey[:-1, :]) / hx
        w = area * u
        if self.inv_mu is not None:
            w = w * self.inv_mu[:, :, None]
        Yx = torch.zeros_like(Ex)
        Yy = torch.zeros_like(Ey)
        Yx[:, :-1] += w / hy  # bottom edges
        Yx[:, 1:] += -w / hy  # top edges
        Yy[:-1, :] += -w / hx  # left edges
        Yy[1:, :] += w / hx  # right edges
        out = self._from_grids(Yx, Yy, m) * self.mask[:, None]
        return out[:, 0] if vec else out

    def M_mm(self, X):
        """Mass apply: per-direction tridiagonal stencil from the exact
        element mass blocks (hx*hy/3 diag within a cell pair, hx*hy/6
        coupling)."""
        vec = X.dim() == 1
        Xl = (X[:, None] if vec else X) * self.mask[:, None]
        m = Xl.shape[1]
        hx, hy = self.a / self.nx, self.b / self.ny
        c3, c6 = hx * hy / 3.0, hx * hy / 6.0
        Ex, Ey = self._to_grids(Xl)
        ep = 1.0 if self.eps is None else self.eps[:, :, None]
        Yx = torch.zeros_like(Ex)
        bot, top = Ex[:, :-1], Ex[:, 1:]
        Yx[:, :-1] += ep * (c3 * bot + c6 * top)
        Yx[:, 1:] += ep * (c6 * bot + c3 * top)
        Yy = torch.zeros_like(Ey)
        left, right = Ey[:-1, :], Ey[1:, :]
        Yy[:-1, :] += ep * (c3 * left + c6 * right)
        Yy[1:, :] += ep * (c6 * left + c3 * right)
        out = self._from_grids(Yx, Yy, m) * self.mask[:, None]
        return out[:, 0] if vec else out

    def KM_mm(self, X):
        return self.K_mm(X), self.M_mm(X)

    def Minv_mm(self, X):
        return cg(
            self.M_mm, X, tol=self.mass_tol, maxiter=self.mass_iters,
            dot=self.dot_cols,
        )

    def _g_grid(self, q):
        """(n_padded, m) <- G q for interior nodal q (grid form)."""
        nx, ny = self.nx, self.ny
        hx, hy = self.a / nx, self.b / ny
        m = q.shape[1]
        phin = q.new_zeros((nx + 1, ny + 1, m))
        phin[1:nx, 1:ny] = q.reshape(nx - 1, ny - 1, m)
        Ex = (phin[1:] - phin[:-1]) / hx
        Ey = (phin[:, 1:] - phin[:, :-1]) / hy
        return self._from_grids(Ex, Ey, m) * self.mask[:, None]

    def _gt_grid(self, Y):
        """((nx-1)(ny-1), m) <- G^T Y over interior nodes (grid form)."""
        nx, ny = self.nx, self.ny
        hx, hy = self.a / nx, self.b / ny
        Ex, Ey = self._to_grids(Y * self.mask[:, None])
        acc = (Ex[:-1, 1:ny] - Ex[1:, 1:ny]) / hx
        acc = acc + (Ey[1:nx, :-1] - Ey[1:nx, 1:]) / hy
        return acc.reshape(-1, Y.shape[1])

    def project(self, X):
        """Mask PEC dims AND remove the gradient component."""
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
        a=1.0, b=1.0, nx=16, ny=16, dtype: torch.dtype = torch.float32,
        block: int = 8, eps_r=None, mu_r=None, bc: str = "pec",
        device: str | torch.device = "cuda",
    ) -> "StencilPencil2D":
        import scipy.sparse as sp

        n_xe = nx * (ny + 1)
        n_ye = (nx + 1) * ny
        n = n_xe + n_ye
        n_padded = _round_up(n, block * max(128 // block, 1))

        mask = np.zeros(n_padded, dtype=numpy_dtype(dtype))
        xi, xj = np.meshgrid(np.arange(nx), np.arange(ny + 1), indexing="ij")
        keep_x = (
            (xj != 0) & (xj != ny) if bc == "pec" else np.ones_like(xj, bool)
        )
        mask[:n_xe] = keep_x.reshape(-1).astype(mask.dtype)
        yi, yj = np.meshgrid(np.arange(nx + 1), np.arange(ny), indexing="ij")
        keep_y = (
            (yi != 0) & (yi != nx) if bc == "pec" else np.ones_like(yi, bool)
        )
        mask[n_xe:n] = keep_y.reshape(-1).astype(mask.dtype)

        # discrete gradient over interior nodes, full-edge row space
        hx, hy = a / nx, b / ny

        def node(i, j):
            return j * (nx + 1) + i

        rows, cols, vals = [], [], []
        # flat Ex layout here is row-major (i, j): id = i*(ny+1)+j
        # (differs from RectCavity2D's assembled numbering)
        eid_x = (xi * (ny + 1) + xj).reshape(-1)
        for dn, sgn in (((1, 0), 1.0 / hx), ((0, 0), -1.0 / hx)):
            rows.append(eid_x)
            cols.append(node(xi + dn[0], xj + dn[1]).reshape(-1))
            vals.append(np.full(eid_x.size, sgn))
        eid_y = n_xe + (yi * ny + yj).reshape(-1)
        for dn, sgn in (((0, 1), 1.0 / hy), ((0, 0), -1.0 / hy)):
            rows.append(eid_y)
            cols.append(node(yi + dn[0], yj + dn[1]).reshape(-1))
            vals.append(np.full(eid_y.size, sgn))
        G_full = sp.coo_matrix(
            (
                np.concatenate(vals),
                (np.concatenate(rows), np.concatenate(cols)),
            ),
            shape=(n, (nx + 1) * (ny + 1)),
        ).tocsr()
        ni, nj = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), indexing="ij")
        if bc == "pec":
            interior = (
                (ni.reshape(-1) > 0)
                & (ni.reshape(-1) < nx)
                & (nj.reshape(-1) > 0)
                & (nj.reshape(-1) < ny)
            )
        else:  # natural BC: all hats modulo the constant (ground node 0)
            interior = node(ni.reshape(-1), nj.reshape(-1)) != 0
        # zero out masked edge rows so G maps into the masked subspace
        keep_rows = np.concatenate([keep_x.reshape(-1), keep_y.reshape(-1)])
        G_full = sp.diags(keep_rows.astype(float)) @ G_full
        G = G_full[:, node(ni.reshape(-1), nj.reshape(-1))[interior]]
        proj = GradientProjector.from_gradient(
            G.tocsr(), n_padded, dtype=dtype, device=device
        )

        fastproj = None
        if eps_r is None and bc == "pec":
            # the tensor-product fast solve assumes Dirichlet interior nodes
            from maxwell_tpu_torch.solvers.fast_poisson import FastPoisson2D

            fastproj = FastPoisson2D.build(
                a, b, nx, ny, dtype=dtype, device=device
            )
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return StencilPencil2D(
            mask=t(mask),
            proj=proj,
            a=a, b=b, nx=nx, ny=ny, n=n, n_padded=n_padded,
            inv_mu=None if mu_r is None else t(1.0 / np.asarray(mu_r)),
            eps=None if eps_r is None else t(eps_r),
            fastproj=fastproj,
        )
