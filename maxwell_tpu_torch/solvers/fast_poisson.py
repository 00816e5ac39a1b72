"""Exact tensor-product solver for the projector's nodal system.

On a uniform tensor grid the nodal operator L = G^T M G (interior nodes,
Dirichlet) is separable:

    L = A_x (x) M_y (x) M_z + M_x (x) A_y (x) M_z + M_x (x) M_y (x) A_z

with 1D hat stiffness A_d and mass M_d. The generalized 1D eigenproblems
A_d V_d = M_d V_d Lam_d (V_d^T M_d V_d = I, solved once on the host)
diagonalize L: q = V (Lam_x (+) Lam_y (+) Lam_z)^-1 V^T r, where each V
factor is a dense transform along one grid axis — plain dense products
(torch.einsum), as the reference left them to XLA. Valid for uniform
(vacuum) mass matrices only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg
import torch


def _modes_1d(n_cells: int, h: float):
    """Generalized eigenpairs of the 1D interior hat (A, M):
    A = (1/h) tridiag(-1, 2, -1), M = (h/6) tridiag(1, 4, 1), size n-1."""
    k = n_cells - 1
    A = (1.0 / h) * (2 * np.eye(k) - np.eye(k, k=1) - np.eye(k, k=-1))
    M = (h / 6.0) * (4 * np.eye(k) + np.eye(k, k=1) + np.eye(k, k=-1))
    lam, V = scipy.linalg.eigh(A, M)  # V^T M V = I
    return lam, V


@dataclasses.dataclass(frozen=True)
class FastPoisson3D:
    """q = L^-1 r for interior-node grids r of shape
    ((nx-1)(ny-1)(nz-1), m), row-major (i, j, k)."""

    Vx: torch.Tensor
    Vy: torch.Tensor
    Vz: torch.Tensor
    inv_lam: torch.Tensor  # (nx-1, ny-1, nz-1)
    nx: int
    ny: int
    nz: int

    @staticmethod
    def build(a, b, c, nx, ny, nz, dtype=torch.float64,
              device="cuda") -> "FastPoisson3D":
        lx, Vx = _modes_1d(nx, a / nx)
        ly, Vy = _modes_1d(ny, b / ny)
        lz, Vz = _modes_1d(nz, c / nz)
        lam = lx[:, None, None] + ly[None, :, None] + lz[None, None, :]
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return FastPoisson3D(
            Vx=t(Vx), Vy=t(Vy), Vz=t(Vz), inv_lam=t(1.0 / lam),
            nx=nx, ny=ny, nz=nz,
        )

    @staticmethod
    def from_reference(f, device: str | torch.device = "cuda") -> "FastPoisson3D":
        """Carry a JAX FastPoisson3D (Vx, Vy, Vz, inv_lam) over."""
        t = lambda v: torch.from_numpy(np.array(v)).to(device)
        return FastPoisson3D(
            Vx=t(f.Vx), Vy=t(f.Vy), Vz=t(f.Vz), inv_lam=t(f.inv_lam),
            nx=int(f.nx), ny=int(f.ny), nz=int(f.nz),
        )

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        kx, ky, kz = self.nx - 1, self.ny - 1, self.nz - 1
        m = r.shape[1]
        R = r.reshape(kx, ky, kz, m)
        # forward transform: R~ = (Vx^T x Vy^T x Vz^T) R
        R = torch.einsum("ia,ajkm->ijkm", self.Vx.T, R)
        R = torch.einsum("jb,ibkm->ijkm", self.Vy.T, R)
        R = torch.einsum("kc,ijcm->ijkm", self.Vz.T, R)
        R = R * self.inv_lam[:, :, :, None]
        # back transform: q = (Vx x Vy x Vz) R~
        R = torch.einsum("ia,ajkm->ijkm", self.Vx, R)
        R = torch.einsum("jb,ibkm->ijkm", self.Vy, R)
        R = torch.einsum("kc,ijcm->ijkm", self.Vz, R)
        return R.reshape(kx * ky * kz, m)


@dataclasses.dataclass(frozen=True)
class FastPoisson2D:
    """2D variant (interior nodes (nx-1)(ny-1), i-major)."""

    Vx: torch.Tensor
    Vy: torch.Tensor
    inv_lam: torch.Tensor
    nx: int
    ny: int

    @staticmethod
    def build(a, b, nx, ny, dtype=torch.float64,
              device="cuda") -> "FastPoisson2D":
        lx, Vx = _modes_1d(nx, a / nx)
        ly, Vy = _modes_1d(ny, b / ny)
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return FastPoisson2D(
            Vx=t(Vx), Vy=t(Vy), inv_lam=t(1.0 / (lx[:, None] + ly[None, :])),
            nx=nx, ny=ny,
        )

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        kx, ky = self.nx - 1, self.ny - 1
        m = r.shape[1]
        R = r.reshape(kx, ky, m)
        R = torch.einsum("ia,ajm->ijm", self.Vx.T, R)
        R = torch.einsum("jb,ibm->ijm", self.Vy.T, R)
        R = R * self.inv_lam[:, :, None]
        R = torch.einsum("ia,ajm->ijm", self.Vx, R)
        R = torch.einsum("jb,ibm->ijm", self.Vy, R)
        return R.reshape(kx * ky, m)
