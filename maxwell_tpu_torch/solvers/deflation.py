"""Deflation: gradient-nullspace projection and locked-eigenvector deflation.

The curl-curl stiffness K has the discrete gradient range(G) as an exact
nullspace (one dimension per interior node). The solvers work in the
M-orthogonal complement of range(G):

    P x = x - G (G^T M G)^{-1} G^T M x

G is applied matrix-free from head/tail node indices (two nonzeros per
row): a gather for G @ phi, and for G^T @ y a gather of each node's
incident edges and a sum over them. The reference scatter-adds G^T @ y; on
a CUDA device a scatter-add (index_add_) adds in whatever order its
atomics land, so two runs of a solve would differ in their last bits.

Across processes (dist/procs.py) every rank holds all of G: G @ phi (phi,
the node vector, is replicated) runs over the edges of the rank's own
rows, and G^T @ y first gathers y from every rank (`gather`, the pencil's
link) and then sums each node's edges as one process does, so P
processes project bit for bit as one. (The reference finishes a per-shard scatter with a psum,
maxwell_tpu/dist/partition.py:508-516, which adds a node's edges in
another order on another mesh.)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from maxwell_tpu_torch.solvers.cg import cg


def _incidence(head: np.ndarray, tail: np.ndarray, n: int, n_nodes: int):
    """(n_nodes, D) ids of each node's incident edges (n, a zero row, pads
    a node with fewer than D) in edge order, and the sign G gives each (+1
    at the head, -1 at the tail)."""
    edge = np.concatenate([np.arange(n), np.arange(n)])
    node = np.concatenate([head, tail])
    sign = np.repeat([1.0, -1.0], n)
    keep = node < n_nodes  # the ghost slot is no node
    edge, node, sign = edge[keep], node[keep], sign[keep]
    order = np.lexsort((edge, node))
    edge, node, sign = edge[order], node[order], sign[order]
    count = np.bincount(node, minlength=n_nodes)
    pos = np.arange(node.size) - (np.cumsum(count) - count)[node]
    ids = np.full((n_nodes, max(int(count.max(initial=0)), 1)), n, np.int64)
    signs = np.zeros(ids.shape)
    ids[node, pos] = edge
    signs[node, pos] = sign
    return ids, signs


@dataclasses.dataclass(frozen=True)
class GradientProjector:
    """M-orthogonal projector onto the complement of the gradient nullspace.

    head/tail: (n,) int64 node ids per edge (n_nodes = ghost slot for an
    endpoint on the PEC boundary); weight: (n,) signed magnitude 1/h_edge.
    Vectors are padded to n_padded rows (zero padding preserved). Across
    processes (see the module docstring) the edges are every rank's,
    n_padded the global rows, `rows` the (start, stop) of this process's
    and `gather` its rows -> every rank's, stacked; vectors are the
    process's rows. None: one process.
    """

    head: torch.Tensor
    tail: torch.Tensor
    weight: torch.Tensor
    n: int
    n_nodes: int
    n_padded: int
    rows: tuple | None = None
    gather: object = dataclasses.field(default=None, compare=False)

    @functools.cached_property
    def incidence(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(node_edges, node_signs), each (n_nodes, D), for G^T @ y (see
        _incidence); built at the first G^T apply (a stencil pencil with
        its grid-form projector never makes one)."""
        ids, signs = _incidence(self.head.cpu().numpy(),
                                self.tail.cpu().numpy(), self.n, self.n_nodes)
        dev = self.head.device
        return (torch.from_numpy(ids).to(dev),
                torch.from_numpy(signs).to(dtype=self.weight.dtype, device=dev))

    @staticmethod
    def from_gradient(
        G: sp.spmatrix, n_padded: int, dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda", rows=None, gather=None,
    ) -> "GradientProjector":
        """Build from the assembled discrete gradient (rows = edges, cols =
        nodes): +w at the head node and -w at the tail node of each edge.
        rows, gather: a process's rows of the stacked edges across
        processes and the gather of every rank's (see the class
        docstring)."""
        G = sp.coo_matrix(G)
        n, n_nodes = G.shape
        head = np.full(n, n_nodes, dtype=np.int64)  # default: ghost slot
        tail = np.full(n, n_nodes, dtype=np.int64)
        weight = np.zeros(n, dtype=np.float64)
        pos = G.data > 0
        head[G.row[pos]] = G.col[pos]
        tail[G.row[~pos]] = G.col[~pos]
        weight[G.row[pos]] = G.data[pos]
        weight[G.row[~pos]] = -G.data[~pos]
        return GradientProjector(
            head=torch.as_tensor(head, device=device),
            tail=torch.as_tensor(tail, device=device),
            weight=torch.as_tensor(weight, dtype=dtype, device=device),
            n=n,
            n_nodes=n_nodes,
            n_padded=n_padded,
            rows=rows,
            gather=gather,
        )

    @staticmethod
    def from_reference(
        p, device: str | torch.device = "cuda"
    ) -> "GradientProjector":
        """Carry a JAX GradientProjector (head/tail/weight) over."""
        t = lambda v: torch.from_numpy(np.array(v)).to(device)
        return GradientProjector(
            head=t(p.head).long(), tail=t(p.tail).long(),
            weight=t(p.weight), n=int(p.n), n_nodes=int(p.n_nodes),
            n_padded=int(p.n_padded),
        )

    @functools.cached_property
    def own_edges(self) -> tuple:
        """(head, tail, weight, padding rows) of this process's rows: the
        edges among them and how many of them lie past the last edge."""
        start, stop = (0, self.n_padded) if self.rows is None else self.rows
        lo, hi = min(start, self.n), min(stop, self.n)
        return (self.head[lo:hi], self.tail[lo:hi], self.weight[lo:hi],
                (stop - start) - (hi - lo))

    def g_mm(self, phi: torch.Tensor) -> torch.Tensor:
        """(n_padded, m) <- G @ phi for phi (n_nodes, m): across processes
        this process's rows."""
        head, tail, weight, pad = self.own_edges
        w = weight if phi.dim() == 1 else weight[:, None]
        zero = phi.new_zeros((1,) + tuple(phi.shape[1:]))
        phi_ext = torch.cat([phi, zero], dim=0)  # ghost node reads 0
        out = w * (phi_ext[head] - phi_ext[tail])
        if pad:
            out = torch.cat([out, out.new_zeros((pad,) + tuple(out.shape[1:]))])
        return out

    def gt_mm(self, y: torch.Tensor) -> torch.Tensor:
        """(n_nodes, m) <- G^T @ y for y (n_padded, m), across processes
        this process's rows (gathered first)."""
        if self.gather is not None:
            y = self.gather(y)
        y = y[: self.n]
        vec = y.dim() == 1
        w = self.weight if vec else self.weight[:, None]
        wy = torch.cat([w * y, y.new_zeros((1,) + tuple(y.shape[1:]))])
        edges, signs = self.incidence
        return (wy[edges] * (signs if vec else signs[..., None])).sum(dim=1)

    def project(
        self,
        M_mm: Callable[[torch.Tensor], torch.Tensor],
        X: torch.Tensor,
        tol: float = 1e-10,
        maxiter: int = 150,
        dot=None,
    ) -> torch.Tensor:
        """X <- X - G (G^T M G)^-1 G^T M X, the nodal system by CG."""
        vec_in = X.dim() == 1
        if vec_in:
            X = X[:, None]
        L_mm = lambda phi: self.gt_mm(M_mm(self.g_mm(phi)))
        rhs = self.gt_mm(M_mm(X))
        q = cg(L_mm, rhs, tol=tol, maxiter=maxiter, dot=dot)
        out = X - self.g_mm(q)
        return out[:, 0] if vec_in else out


def deflate_against(
    X: torch.Tensor, Q: torch.Tensor, MQ: torch.Tensor, dot_mm=None
) -> torch.Tensor:
    """X <- X - Q (MQ^T X): remove components along locked M-orthonormal Q
    (MQ = M @ Q precomputed)."""
    if dot_mm is None:
        dot_mm = lambda A, B: A.T @ B
    return X - Q @ dot_mm(MQ, X)
