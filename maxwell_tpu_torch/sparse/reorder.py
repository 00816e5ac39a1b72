"""Bandwidth-reducing DOF reordering (SURVEY.md §2 C15 partitioner support).

The raw edge numbering groups x/y/z edge families in separate contiguous
ranges, so inter-family curl-curl coupling spans the whole matrix — terrible
for contiguous block-row partitioning (halo depth ~ n). Reverse Cuthill-McKee
on the K+M pattern restores geometric locality: halos shrink to a surface
band, and BSR block density improves. Eigenvalues are invariant; eigenvectors
come back permuted and are scattered back by `unpermute_rows`.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


def rcm_permutation(K: sp.spmatrix, M: sp.spmatrix | None = None) -> np.ndarray:
    """Symmetric RCM permutation of the combined sparsity pattern."""
    pat = K if M is None else (abs(K) + abs(M))
    return np.asarray(
        reverse_cuthill_mckee(sp.csr_matrix(pat), symmetric_mode=True)
    )


class PermutedProblem:
    """View of a cavity problem with RCM-permuted edge DOFs.

    Exposes the same (K, M, G, n_edges, analytic_eigenvalues) surface as
    RectCavity2D / BrickCavity3D, so Pencil.from_problem / partition_problem
    work unchanged. perm maps new index -> old index (A'[i,j] =
    A[perm[i], perm[j]]).
    """

    def __init__(self, problem, perm: np.ndarray | None = None):
        self.base = problem
        self.perm = (
            perm if perm is not None else rcm_permutation(problem.K, problem.M)
        )
        p = self.perm
        self.K = problem.K[p][:, p].tocsr()
        self.M = problem.M[p][:, p].tocsr()
        self.G = problem.G[p].tocsr()
        self.n_edges = problem.n_edges

    def analytic_eigenvalues(self, count: int):
        return self.base.analytic_eigenvalues(count)


def unpermute_rows(X: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Scatter permuted rows back to the original ordering."""
    out = np.empty_like(X)
    out[perm] = X
    return out
