"""3D brick cavity, lowest-order Nedelec (hex) edge elements on a tensor grid.

Capability target: SURVEY.md §2 C1/C2 and BASELINE.json config 4 ("3D
edge-element (Nedelec) cavity: BSR curl-curl operator ...").

Grid: nx x ny x nz cells on [0,a]x[0,b]x[0,c]. Edge DOFs by direction:
x-edges (i<nx, j<=ny, k<=nz), y-edges (i<=nx, j<ny, k<=nz), z-edges
(i<=nx, j<=ny, k<nz); all oriented along +axis, unit-tangential-value basis.

On one cell the 12 basis functions are tensor products of the 1D hats
lam0(t)=1-t, lam1(t)=t in the transverse coordinates, e.g. the x-edge at
(y-level j+beta, z-level k+gamma) carries N = (lam_beta(y/hy)lam_gamma(z/hz),
0, 0). Element integrals K_e = int curl Ni . curl Nj and M_e = int Ni . Nj are
evaluated with 2x2x2 Gauss quadrature, which is exact for these polynomials;
the uniform grid means one (K_e, M_e) pair serves every cell.

PEC: drop edges tangential to any wall. Discrete gradient G over interior
nodes satisfies K @ G = 0 exactly (gradient nullspace, SURVEY.md §7.5).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

_GAUSS = (0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0))  # on [0,1]


def hex_element_matrices(hx: float, hy: float, hz: float):
    """Exact (via 2-pt Gauss) 12x12 curl-curl K_e and mass M_e for one brick.

    Local edge order: 0-3 x-edges (beta,gamma)=(0,0),(1,0),(0,1),(1,1);
    4-7 y-edges (alpha,gamma); 8-11 z-edges (alpha,beta).
    """
    lam = (lambda t: 1.0 - t, lambda t: t)
    dlam = (-1.0, 1.0)
    h = (hx, hy, hz)

    def basis(e, x):
        # returns (N(x), curlN(x)) at normalized point x=(xh, yh, zh) in [0,1]^3
        N = np.zeros(3)
        C = np.zeros(3)
        if e < 4:  # x-edge, transverse dims (y, z)
            b, g = e % 2, e // 2
            N[0] = lam[b](x[1]) * lam[g](x[2])
            C[1] = lam[b](x[1]) * dlam[g] / h[2]
            C[2] = -dlam[b] / h[1] * lam[g](x[2])
        elif e < 8:  # y-edge, transverse dims (x, z)
            a_, g = (e - 4) % 2, (e - 4) // 2
            N[1] = lam[a_](x[0]) * lam[g](x[2])
            C[0] = -lam[a_](x[0]) * dlam[g] / h[2]
            C[2] = dlam[a_] / h[0] * lam[g](x[2])
        else:  # z-edge, transverse dims (x, y)
            a_, b = (e - 8) % 2, (e - 8) // 2
            N[2] = lam[a_](x[0]) * lam[b](x[1])
            C[0] = lam[a_](x[0]) * dlam[b] / h[1]
            C[1] = -dlam[a_] / h[0] * lam[b](x[1])
        return N, C

    Ke = np.zeros((12, 12))
    Me = np.zeros((12, 12))
    w = hx * hy * hz / 8.0  # each of the 8 Gauss points has weight 1/8 * vol
    for gx in _GAUSS:
        for gy in _GAUSS:
            for gz in _GAUSS:
                NB = np.zeros((12, 3))
                CB = np.zeros((12, 3))
                for e in range(12):
                    NB[e], CB[e] = basis(e, (gx, gy, gz))
                Ke += w * CB @ CB.T
                Me += w * NB @ NB.T
    return Ke, Me


@dataclass
class BrickCavity3D:
    """3D brick cavity discretized with lowest-order Nedelec hex edge elements."""

    a: float = 1.0
    b: float = 1.0
    c: float = 1.0
    nx: int = 8
    ny: int = 8
    nz: int = 8
    # optional (nx, ny, nz) per-cell materials: curl (1/mu_r) curl E =
    # k^2 eps_r E (uniform/None = vacuum cavity, analytic oracle valid)
    eps_r: "np.ndarray | None" = None
    mu_r: "np.ndarray | None" = None
    # "pec" eliminates wall-tangential edges; "pmc" (natural BC) keeps all
    # edges — by E<->H duality the nonzero spectrum equals the PEC box's
    bc: str = "pec"

    n_edges: int = field(init=False)
    keep: np.ndarray = field(init=False)
    K: sp.csr_matrix = field(init=False)
    M: sp.csr_matrix = field(init=False)
    G: sp.csr_matrix = field(init=False)

    def __post_init__(self):
        nx, ny, nz = self.nx, self.ny, self.nz
        hx, hy, hz = self.a / nx, self.b / ny, self.c / nz
        n_xe = nx * (ny + 1) * (nz + 1)
        n_ye = (nx + 1) * ny * (nz + 1)
        n_ze = (nx + 1) * (ny + 1) * nz
        n_full = n_xe + n_ye + n_ze

        def xe(i, j, k):
            return (k * (ny + 1) + j) * nx + i

        def ye(i, j, k):
            return n_xe + (k * ny + j) * (nx + 1) + i

        def ze(i, j, k):
            return n_xe + n_ye + (k * (ny + 1) + j) * (nx + 1) + i

        ci, cj, ck = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
        # local edge order must match hex_element_matrices
        elems = np.stack(
            [
                xe(ci, cj + 0, ck + 0),
                xe(ci, cj + 1, ck + 0),
                xe(ci, cj + 0, ck + 1),
                xe(ci, cj + 1, ck + 1),
                ye(ci + 0, cj, ck + 0),
                ye(ci + 1, cj, ck + 0),
                ye(ci + 0, cj, ck + 1),
                ye(ci + 1, cj, ck + 1),
                ze(ci + 0, cj + 0, ck),
                ze(ci + 1, cj + 0, ck),
                ze(ci + 0, cj + 1, ck),
                ze(ci + 1, cj + 1, ck),
            ],
            axis=1,
        )

        Ke, Me = hex_element_matrices(hx, hy, hz)
        rows = np.repeat(elems, 12, axis=1).ravel()
        cols = np.tile(elems, (1, 12)).ravel()
        ncells = elems.shape[0]
        inv_mu = (
            np.ones(ncells)
            if self.mu_r is None
            else 1.0 / np.asarray(self.mu_r)[ci, cj, ck]
        )
        eps = (
            np.ones(ncells)
            if self.eps_r is None
            else np.asarray(self.eps_r)[ci, cj, ck]
        )
        K_full = sp.coo_matrix(
            ((inv_mu[:, None] * Ke.ravel()[None, :]).ravel(), (rows, cols)),
            shape=(n_full, n_full),
        ).tocsr()
        M_full = sp.coo_matrix(
            ((eps[:, None] * Me.ravel()[None, :]).ravel(), (rows, cols)),
            shape=(n_full, n_full),
        ).tocsr()

        # PEC: drop edges lying on any wall they are tangential to
        xi, xj, xk = np.meshgrid(
            np.arange(nx), np.arange(ny + 1), np.arange(nz + 1), indexing="ij"
        )
        keep_x = xe(xi.ravel(), xj.ravel(), xk.ravel())[
            (xj.ravel() != 0)
            & (xj.ravel() != ny)
            & (xk.ravel() != 0)
            & (xk.ravel() != nz)
        ]
        yi, yj, yk = np.meshgrid(
            np.arange(nx + 1), np.arange(ny), np.arange(nz + 1), indexing="ij"
        )
        keep_y = ye(yi.ravel(), yj.ravel(), yk.ravel())[
            (yi.ravel() != 0)
            & (yi.ravel() != nx)
            & (yk.ravel() != 0)
            & (yk.ravel() != nz)
        ]
        zi, zj, zk = np.meshgrid(
            np.arange(nx + 1), np.arange(ny + 1), np.arange(nz), indexing="ij"
        )
        keep_z = ze(zi.ravel(), zj.ravel(), zk.ravel())[
            (zi.ravel() != 0)
            & (zi.ravel() != nx)
            & (zj.ravel() != 0)
            & (zj.ravel() != ny)
        ]
        if self.bc == "pec":
            keep = np.sort(np.concatenate([keep_x, keep_y, keep_z]))
        elif self.bc == "pmc":
            keep = np.arange(n_full)
        else:
            raise ValueError(f"unknown bc {self.bc!r}")
        self.keep = keep
        self.n_edges = keep.size
        # row-slice then column-slice: scipy's np.ix_ path samples the full
        # len(keep)^2 index product (dense — ~12 GB / minutes at 24^3);
        # chained slicing stays sparse and is O(nnz)
        self.K = K_full[keep][:, keep].tocsr()
        self.M = M_full[keep][:, keep].tocsr()

        # discrete gradient over interior nodes
        def node(i, j, k):
            return (k * (ny + 1) + j) * (nx + 1) + i

        # unit-tangential-VALUE basis => gradient entries are +-1/h_edge
        g_rows, g_cols, g_vals = [], [], []
        for ids, edge_id, head, h in (
            ((xi, xj, xk), xe, lambda i, j, k: node(i + 1, j, k), hx),
            ((yi, yj, yk), ye, lambda i, j, k: node(i, j + 1, k), hy),
            ((zi, zj, zk), ze, lambda i, j, k: node(i, j, k + 1), hz),
        ):
            i, j, k = (a.ravel() for a in ids)
            eid = edge_id(i, j, k)
            g_rows += [eid, eid]
            g_cols += [head(i, j, k), node(i, j, k)]
            g_vals += [np.full(eid.size, 1.0 / h), np.full(eid.size, -1.0 / h)]
        n_nodes = (nx + 1) * (ny + 1) * (nz + 1)
        G_full = sp.coo_matrix(
            (
                np.concatenate(g_vals),
                (np.concatenate(g_rows), np.concatenate(g_cols)),
            ),
            shape=(n_full, n_nodes),
        ).tocsr()
        ni, nj, nk = np.meshgrid(
            np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1), indexing="ij"
        )
        ni, nj, nk = ni.ravel(), nj.ravel(), nk.ravel()
        if self.bc == "pec":
            interior = (
                (ni > 0) & (ni < nx) & (nj > 0) & (nj < ny)
                & (nk > 0) & (nk < nz)
            )
        else:  # natural BC: all hats modulo the constant (ground node 0)
            interior = node(ni, nj, nk) != 0
        self.G = G_full[keep][:, node(ni, nj, nk)[interior]].tocsr()

    def analytic_eigenvalues(self, count: int) -> np.ndarray:
        from maxwell_tpu_torch.problems.analytic import cavity_eigenvalues_3d

        return cavity_eigenvalues_3d(self.a, self.b, self.c, count)
