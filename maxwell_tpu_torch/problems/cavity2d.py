"""2D rectangular cavity, lowest-order (Whitney-1) edge elements on a tensor
grid — assembly of the curl-curl stiffness K and mass M in scipy CSR, the
discrete gradient G (exact nullspace of K), and PEC boundary elimination.

Capability target: SURVEY.md §2 C1/C2 and BASELINE.json config 1 ("2D
rectangular cavity TE modes ... eigenvalues vs analytic").

Discretization notes
--------------------
Grid: nx x ny cells on [0,a]x[0,b], hx=a/nx, hy=b/ny. Edge DOFs: x-directed
edges at (cell i, node-row j), y-directed edges at (node-col i, cell j); all
x-edges oriented +x, all y-edges +y ("unit tangential value" basis convention).

On one cell the four local basis functions (bottom/top x-edges, left/right
y-edges) are

    N_b = ((hy-y)/hy, 0)   N_t = (y/hy, 0)
    N_l = (0, (hx-x)/hx)   N_r = (0, x/hx)

with scalar curls c = (1/hy, -1/hy, -1/hx, 1/hx). Exact element integrals:

    K_e = hx*hy * outer(c, c)
    M_e = hx*hy * blockdiag([[1/3,1/6],[1/6,1/3]], [[1/3,1/6],[1/6,1/3]])

PEC (tangential E = 0): drop x-edges on y=0,b and y-edges on x=0,a.
The discrete gradient G (interior nodes -> kept edges) satisfies K @ G = 0
exactly; its range is the spurious lambda=0 eigenspace that solvers must
deflate (SURVEY.md §7.5 hard part 2).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp


@dataclass
class RectCavity2D:
    """2D rectangular cavity discretized with lowest-order edge elements.

    eps_r / mu_r: optional (nx, ny) per-cell relative permittivity /
    permeability. The eigenproblem becomes curl (1/mu_r) curl E =
    k^2 eps_r E; uniform (None) reproduces the vacuum cavity whose modes
    the analytic oracle describes.
    """

    a: float = 1.0
    b: float = 1.0
    nx: int = 16
    ny: int = 16
    eps_r: "np.ndarray | None" = None
    mu_r: "np.ndarray | None" = None
    # "pec": tangential E = 0 (eliminate wall edges; TE modes
    # pi^2(m^2/a^2+n^2/b^2), m,n>=0 not both 0).
    # "pmc": natural/do-nothing BC (keep all edges; nonzero modes are the
    # DIRICHLET Laplacian eigenvalues, m,n>=1; nullspace = grad H1, all
    # nodes modulo constants).
    bc: str = "pec"

    # filled by __post_init__
    n_edges: int = field(init=False)
    keep: np.ndarray = field(init=False)  # kept (interior-tangential) edge ids
    K: sp.csr_matrix = field(init=False)  # curl-curl stiffness, SPSD
    M: sp.csr_matrix = field(init=False)  # mass, SPD
    G: sp.csr_matrix = field(init=False)  # discrete gradient, K @ G == 0

    def __post_init__(self):
        nx, ny = self.nx, self.ny
        hx, hy = self.a / nx, self.b / ny
        n_xe = nx * (ny + 1)  # x-edge (i, j): id = j*nx + i
        n_ye = (nx + 1) * ny  # y-edge (i, j): id = n_xe + j*(nx+1) + i
        n_edges_full = n_xe + n_ye

        # --- per-cell local->global edge map, vectorized over all cells -----
        ci, cj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        ci, cj = ci.ravel(), cj.ravel()  # cell (ci, cj)
        bot = cj * nx + ci
        top = (cj + 1) * nx + ci
        left = n_xe + cj * (nx + 1) + ci
        right = n_xe + cj * (nx + 1) + (ci + 1)
        # (ncells, 4) local edge order: [bottom, top, left, right]
        elems = np.stack([bot, top, left, right], axis=1)

        # --- element matrices (exact integrals) ----------------------------
        c = np.array([1.0 / hy, -1.0 / hy, -1.0 / hx, 1.0 / hx])
        Ke = hx * hy * np.outer(c, c)
        m2 = np.array([[1.0 / 3, 1.0 / 6], [1.0 / 6, 1.0 / 3]])
        Me = hx * hy * np.block(
            [[m2, np.zeros((2, 2))], [np.zeros((2, 2)), m2]]
        )

        # --- global assembly (COO scatter; per-cell material scaling) ------
        rows = np.repeat(elems, 4, axis=1).ravel()
        cols = np.tile(elems, (1, 4)).ravel()
        ncells = elems.shape[0]
        inv_mu = (
            np.ones(ncells)
            if self.mu_r is None
            else 1.0 / np.asarray(self.mu_r)[ci, cj]
        )
        eps = (
            np.ones(ncells)
            if self.eps_r is None
            else np.asarray(self.eps_r)[ci, cj]
        )
        K_full = sp.coo_matrix(
            ((inv_mu[:, None] * Ke.ravel()[None, :]).ravel(), (rows, cols)),
            shape=(n_edges_full, n_edges_full),
        ).tocsr()
        M_full = sp.coo_matrix(
            ((eps[:, None] * Me.ravel()[None, :]).ravel(), (rows, cols)),
            shape=(n_edges_full, n_edges_full),
        ).tocsr()

        # --- boundary elimination (PEC) or none (PMC/natural) --------------
        if self.bc == "pec":
            xe_i, xe_j = np.meshgrid(
                np.arange(nx), np.arange(ny + 1), indexing="ij"
            )
            keep_xe = (xe_j.ravel() != 0) & (xe_j.ravel() != ny)
            keep_xe_ids = (xe_j.ravel() * nx + xe_i.ravel())[keep_xe]
            ye_i, ye_j = np.meshgrid(
                np.arange(nx + 1), np.arange(ny), indexing="ij"
            )
            keep_ye = (ye_i.ravel() != 0) & (ye_i.ravel() != nx)
            keep_ye_ids = (n_xe + ye_j.ravel() * (nx + 1) + ye_i.ravel())[
                keep_ye
            ]
            keep = np.sort(np.concatenate([keep_xe_ids, keep_ye_ids]))
        elif self.bc == "pmc":
            keep = np.arange(n_edges_full)
        else:
            raise ValueError(f"unknown bc {self.bc!r}")

        self.keep = keep
        self.n_edges = keep.size
        # row-slice then column-slice: scipy's np.ix_ path samples the full
        # len(keep)^2 index product (dense); chained slicing stays O(nnz)
        self.K = K_full[keep][:, keep].tocsr()
        self.M = M_full[keep][:, keep].tocsr()

        # --- discrete gradient (interior nodes only) -----------------------
        # node (i, j) id = j*(nx+1) + i ; interior: 0<i<nx, 0<j<ny
        def node_id(i, j):
            return j * (nx + 1) + i

        # With the unit-tangential-VALUE basis convention, the edge DOF of
        # grad(phi) is (phi(head) - phi(tail)) / h_edge, so G carries +-1/h.
        g_rows, g_cols, g_vals = [], [], []
        # x-edge (i, j): tail node (i, j), head node (i+1, j)
        xi, xj = np.meshgrid(np.arange(nx), np.arange(ny + 1), indexing="ij")
        xi, xj = xi.ravel(), xj.ravel()
        eid = xj * nx + xi
        for dn, sgn in (((1, 0), 1.0 / hx), ((0, 0), -1.0 / hx)):
            ni, nj = xi + dn[0], xj + dn[1]
            g_rows.append(eid)
            g_cols.append(node_id(ni, nj))
            g_vals.append(np.full(eid.shape, sgn))
        # y-edge (i, j): tail node (i, j), head node (i, j+1)
        yi, yj = np.meshgrid(np.arange(nx + 1), np.arange(ny), indexing="ij")
        yi, yj = yi.ravel(), yj.ravel()
        eid = n_xe + yj * (nx + 1) + yi
        for dn, sgn in (((0, 1), 1.0 / hy), ((0, 0), -1.0 / hy)):
            ni, nj = yi + dn[0], yj + dn[1]
            g_rows.append(eid)
            g_cols.append(node_id(ni, nj))
            g_vals.append(np.full(eid.shape, sgn))

        n_nodes_full = (nx + 1) * (ny + 1)
        G_full = sp.coo_matrix(
            (
                np.concatenate(g_vals),
                (np.concatenate(g_rows), np.concatenate(g_cols)),
            ),
            shape=(n_edges_full, n_nodes_full),
        ).tocsr()
        node_i, node_j = np.meshgrid(
            np.arange(nx + 1), np.arange(ny + 1), indexing="ij"
        )
        if self.bc == "pec":
            # gradients of hats vanishing on the wall: interior nodes only
            interior = (
                (node_i.ravel() > 0)
                & (node_i.ravel() < nx)
                & (node_j.ravel() > 0)
                & (node_j.ravel() < ny)
            )
        else:
            # natural BC: gradients of ALL hats, modulo the constant (ground
            # node 0)
            ids = node_id(node_i.ravel(), node_j.ravel())
            interior = ids != 0
        interior_ids = node_id(node_i.ravel(), node_j.ravel())[interior]
        self.G = G_full[keep][:, interior_ids].tocsr()

    def analytic_eigenvalues(self, count: int) -> np.ndarray:
        if self.bc == "pmc":
            # natural BC => nonzero curl-curl modes = DIRICHLET Laplacian
            # eigenvalues of the stream function: m, n >= 1
            vals = [
                (np.pi * m / self.a) ** 2 + (np.pi * n / self.b) ** 2
                for m in range(1, 40)
                for n in range(1, 40)
            ]
            return np.sort(np.asarray(vals))[:count]
        from maxwell_tpu_torch.problems.analytic import te_eigenvalues_2d

        return te_eigenvalues_2d(self.a, self.b, count)
