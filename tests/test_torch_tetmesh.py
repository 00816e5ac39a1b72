"""Tetrahedral meshes and golden fixtures of maxwell_tpu_torch
(problems/tetmesh.py, problems/golden.py and golden.json) against the JAX
package's: the Kuhn mesh, the Whitney element matrices and TetCavity's K, M
and G equal the reference's; the CLI's jiggled mesh is the reference CLI's;
golden.json is a byte copy and the port's solvers reproduce it as
tests/unit/test_golden.py checks the reference's; config 6 through the
port's CLI gives the reference CLI's eigenvalues."""

import contextlib
import io
import json
from pathlib import Path

import jax.numpy as jnp  # noqa: F401  (the reference's x64 setting)
import numpy as np
import pytest
import scipy.linalg
import torch

from maxwell_tpu.cli import run as ref_cli
from maxwell_tpu.problems import tetmesh as ref_tetmesh
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.problems import golden, tetmesh
from maxwell_tpu_torch.solvers import lobpcg
from maxwell_tpu_torch.solvers.operator import Pencil
from maxwell_tpu_torch.solvers.precond import shifted_cg_preconditioner

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG6 = ROOT / "configs" / "config6_tet.json"


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def test_brick_tet_mesh_equals_reference():
    got = tetmesh.brick_tet_mesh(1.0, 2.0, 0.5, 3, 2, 4)
    want = ref_tetmesh.brick_tet_mesh(1.0, 2.0, 0.5, 3, 2, 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_whitney_element_matrices_equal_reference():
    rng = np.random.default_rng(3)
    verts, tets = tetmesh.brick_tet_mesh(1, 1, 1, 2, 2, 2)
    verts = verts + 0.05 * rng.standard_normal(verts.shape)
    got = tetmesh.whitney_element_matrices(verts, tets)
    want = ref_tetmesh.whitney_element_matrices(verts, tets)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("n", [2, 4])
def test_tet_cavity_equals_reference(n):
    got, want = tetmesh.TetCavity(n=n), ref_tetmesh.TetCavity(n=n)
    assert got.n_edges == want.n_edges
    for f in ("K", "M", "G"):
        assert _same_csr(getattr(got, f), getattr(want, f)), f
    np.testing.assert_array_equal(got.analytic_eigenvalues(4),
                                  want.analytic_eigenvalues(4))


def test_cli_jiggled_mesh_equals_reference():
    pcfg = json.loads(CONFIG6.read_text())["problem"]
    got, want = port_cli.build_problem(pcfg), ref_cli.build_problem(pcfg)
    assert np.array_equal(got.verts, want.verts)
    assert np.array_equal(got.tets, want.tets)
    for f in ("K", "M", "G"):
        assert _same_csr(getattr(got, f), getattr(want, f)), f
    # the jiggle moved the interior vertices
    plain = tetmesh.TetCavity(n=pcfg["n"])
    assert not np.array_equal(got.verts, plain.verts)


def test_golden_json_is_a_byte_copy():
    assert (ROOT / "maxwell_tpu_torch/problems/golden.json").read_bytes() == (
        ROOT / "maxwell_tpu/problems/golden.json").read_bytes()
    g = golden.load_golden()
    assert set(g) >= {"rect2d_16x16", "brick3d_6x6x6"}


@pytest.mark.parametrize("name", ["rect2d_16x16", "brick3d_6x6x6"])
def test_solver_matches_golden(name):
    vals, tol, pcfg = golden.golden_eigenvalues(name)
    problem = port_cli.build_problem(pcfg)
    pencil = Pencil.from_problem(problem, block=8, dtype=torch.float64,
                                 device="cpu")
    pc = shifted_cg_preconditioner(pencil, alpha=float(vals[0]), iters=20)
    res = lobpcg(pencil, nev=5, maxiter=150, tol=tol, precond=pc)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, vals[:5], rtol=1e-7)


def test_assembly_matches_golden_oracle():
    vals, _, pcfg = golden.golden_eigenvalues("rect2d_12x10")
    cav = port_cli.build_problem(pcfg)
    dense = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(),
                              eigvals_only=True)
    fresh = np.sort(dense[dense > 1e-8])[: len(vals)]
    np.testing.assert_allclose(fresh, vals, rtol=1e-12)


def _last_json(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) in (0, None)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_config6_through_the_cli_matches_the_reference_cli():
    want = _last_json(ref_cli.main, [str(CONFIG6), "--platform", "cpu"])
    got = _last_json(port_cli.main, [str(CONFIG6), "--device", "cpu"])
    assert sorted(got) == sorted(want)
    assert got["converged"] and max(got["residuals"]) <= 1e-8
    assert got["n"] == want["n"]
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=1e-8)
    np.testing.assert_allclose(got["analytic"], want["analytic"])
    # and a dense eigh of the assembled pencil
    cav = port_cli.build_problem(json.loads(CONFIG6.read_text())["problem"])
    w = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(), eigvals_only=True)
    np.testing.assert_allclose(got["eigenvalues"], w[w > 1e-6][:5],
                               rtol=1e-8)
