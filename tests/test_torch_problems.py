"""maxwell_tpu_torch host problems against maxwell_tpu: the copied assembly
and RCM reordering must give identical matrices, and the port must import
neither jax nor the JAX package."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import maxwell_tpu.problems as ref_problems
import maxwell_tpu.sparse.reorder as ref_reorder
import maxwell_tpu_torch.problems as port_problems
import maxwell_tpu_torch.sparse.reorder as port_reorder

torch.set_num_threads(1)

PORT_ROOT = pathlib.Path(port_problems.__file__).resolve().parents[1]

CASES = {
    "rect2d_8x8": ("RectCavity2D", dict(nx=8, ny=8)),
    "rect2d_7x6_pmc": ("RectCavity2D", dict(nx=7, ny=6, bc="pmc")),
    "brick_5x5x5": ("BrickCavity3D", dict(nx=5, ny=5, nz=5)),
    "brick_6x5x4": ("BrickCavity3D", dict(nx=6, ny=5, nz=4)),
}


def _pair(case):
    cls, kw = CASES[case]
    return getattr(ref_problems, cls)(**kw), getattr(port_problems, cls)(**kw)


def _assert_same_csr(A, B):
    A, B = A.tocsr(), B.tocsr()
    A.sort_indices()
    B.sort_indices()
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    np.testing.assert_array_equal(A.data, B.data)


@pytest.mark.parametrize("case", sorted(CASES))
def test_problem_matrices_identical(case):
    ref, port = _pair(case)
    assert port.n_edges == ref.n_edges
    for name in ("K", "M", "G"):
        _assert_same_csr(getattr(ref, name), getattr(port, name))
    np.testing.assert_array_equal(
        port.analytic_eigenvalues(6), ref.analytic_eigenvalues(6)
    )


@pytest.mark.parametrize("case", ["brick_6x5x4", "rect2d_8x8"])
def test_rcm_permuted_problem_identical(case):
    ref, port = _pair(case)
    pr = ref_reorder.PermutedProblem(ref)
    pp = port_reorder.PermutedProblem(port)
    np.testing.assert_array_equal(pr.perm, pp.perm)
    for name in ("K", "M", "G"):
        _assert_same_csr(getattr(pr, name), getattr(pp, name))
    X = np.random.default_rng(0).standard_normal((pp.n_edges, 2))
    np.testing.assert_array_equal(
        port_reorder.unpermute_rows(X, pp.perm),
        ref_reorder.unpermute_rows(X, pr.perm),
    )


def test_port_imports_no_jax():
    """AST scan of every module of the port: no jax, ml_dtypes or
    maxwell_tpu import (importing maxwell_tpu would import jax)."""
    banned = ("jax", "jaxlib", "ml_dtypes", "maxwell_tpu")
    files = sorted(PORT_ROOT.rglob("*.py"))
    assert len(files) > 15
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [
                f"{f.name}: {n}" for n in names if n.split(".")[0] in banned
            ]
    assert not bad, bad
