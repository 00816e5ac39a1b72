"""Lanczos and thick-restart Lanczos of maxwell_tpu_torch against the JAX
package's (config 1's 16x16 rectangle): the factorization's coefficients on
the same start vector, the host Ritz selection, the eigenpairs against the
reference, the dense discrete spectrum and the analytic modes, and the f32
"pallas" route refined to 1e-8."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import maxwell_tpu_torch
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.problems import te_eigenvalues_2d
from maxwell_tpu.solvers import Pencil as RefPencil
import maxwell_tpu.solvers.lanczos  # noqa: F401  (the module, not the function)
from maxwell_tpu.solvers.trlanczos import thick_restart_lanczos as ref_trl
from maxwell_tpu_torch.kernels import bsr_spmm
from maxwell_tpu_torch.problems import RectCavity2D
import maxwell_tpu_torch.solvers.lanczos  # noqa: F401
from maxwell_tpu_torch.solvers.operator import Pencil
from maxwell_tpu_torch.solvers.trlanczos import thick_restart_lanczos

torch.set_num_threads(1)

# the solvers packages export the function `lanczos` under the module's name
ref_lanczos_mod = sys.modules["maxwell_tpu.solvers.lanczos"]
lanczos_mod = sys.modules["maxwell_tpu_torch.solvers.lanczos"]

NEV = 5
KW = dict(nx=16, ny=16)


@pytest.fixture(scope="module")
def setup():
    cav = RefRect(**KW)
    ref = RefPencil.from_problem(cav, block=8, dtype=jnp.float64)
    port = Pencil.from_problem(RectCavity2D(**KW), block=8,
                               dtype=torch.float64, device="cpu")
    dense = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(),
                              eigvals_only=True)
    discrete = np.sort(dense[dense > 1e-8])
    # the reference's own start draw (key 0), zero-padded, for both sides
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                      (ref.n_padded,), dtype=jnp.float64))
    v0[ref.n:] = 0.0
    return cav, ref, port, discrete, v0


def test_lanczos_factorization_matches_reference(setup):
    _, ref, port, _, v0 = setup
    v = lanczos_mod.start_vector(port, v0)
    want_v = ref.project(jnp.asarray(v0))
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=1e-10,
                               atol=1e-12)
    Partial = jax.tree_util.Partial
    a_ref, b_ref, _, _ = ref_lanczos_mod.lanczos_factorization(
        Partial(ref_lanczos_mod._direct_apply, ref), ref, want_v, 40,
        Partial(ref_lanczos_mod._project_apply, ref),
    )
    a, b, V, MV = lanczos_mod.lanczos_factorization(
        functools.partial(lanczos_mod._direct_apply, port), port, v, 40,
        functools.partial(lanczos_mod._project_apply, port),
    )
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=1e-10)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-10)
    # the basis is M-orthonormal
    G = (V @ MV.T).numpy()
    np.testing.assert_allclose(G, np.eye(41), atol=1e-10)


@pytest.mark.parametrize("mode", ["direct", "shift_invert"])
def test_ritz_extract_identical(mode):
    rng = np.random.default_rng(3)
    alphas = np.abs(rng.standard_normal(30)) * 10
    betas = np.abs(rng.standard_normal(30))
    betas[-1] = 1e-9  # a converged tail
    for tol in (1e-8, 1e-2):
        want = ref_lanczos_mod.ritz_extract(alphas, betas, 4, tol, mode, 2.0)
        got = lanczos_mod.ritz_extract(alphas, betas, 4, tol, mode, 2.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def lanczos_pair(setup):
    _, ref, port, _, v0 = setup
    want = ref_lanczos_mod.lanczos(ref, nev=NEV, maxiter=260, tol=1e-8)
    got = lanczos_mod.lanczos(port, nev=NEV, maxiter=260, tol=1e-8, v0=v0)
    return got, want


def test_lanczos_matches_reference_and_discrete(setup, lanczos_pair):
    _, _, _, discrete, _ = setup
    got, want = lanczos_pair
    assert got.converged and got.residuals.max() <= 1e-8
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-8)
    np.testing.assert_allclose(got.eigenvalues, discrete[:NEV], rtol=1e-8)


def test_lanczos_matches_analytic(lanczos_pair):
    got, _ = lanczos_pair
    exact = te_eigenvalues_2d(1.0, 1.0, NEV)
    np.testing.assert_allclose(got.eigenvalues, exact, rtol=2.5e-2)


def test_lanczos_eigenvectors_are_physical(setup, lanczos_pair):
    """Ritz vectors have no gradient component: ||G^T M x|| ~ 0."""
    cav, _, _, _, _ = setup
    got, _ = lanczos_pair
    X = got.eigenvectors
    assert X.shape == (cav.K.shape[0], NEV)
    assert np.abs(cav.G.T @ (cav.M @ X)).max() < 1e-6


def test_thick_restart_matches_reference(setup):
    _, ref, port, discrete, v0 = setup
    want = ref_trl(ref, nev=NEV, ncv=24, max_restarts=60, tol=1e-9)
    got = thick_restart_lanczos(port, nev=NEV, ncv=24, max_restarts=60,
                                tol=1e-9, v0=v0)
    assert got.converged, got.residuals
    assert got.iterations > 24  # really restarted
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-8)
    np.testing.assert_allclose(got.eigenvalues, discrete[:NEV], rtol=1e-8)


def test_pallas_f32_lanczos_refined(setup):
    """The f32 "pallas" route through solve(): the plain blocked-ELL SpMV
    on the CPU, Lanczos cut at 1e-5, the host f64 refine to 1e-8."""
    _, _, _, discrete, _ = setup
    prob = RectCavity2D(**KW)
    pencil = Pencil.from_problem(prob, kernel="pallas", dtype=torch.float32,
                                 device="cpu")
    bsr_spmm.reset_counts()
    f32 = lanczos_mod.lanczos(pencil, nev=NEV, maxiter=260, tol=1e-5)
    c = bsr_spmm.counts()
    assert c["bsr_matvec_ref"] > 0 and c["bsr_matvec"] == 0
    # the f32 Ritz pairs sit at the f32 floor of the inner mass solve
    # (its CG stops at 16 eps relative), a few 1e-5 at this size
    assert f32.residuals.max() <= 1e-4
    np.testing.assert_allclose(f32.eigenvalues, discrete[:NEV], rtol=1e-4)
    res = maxwell_tpu_torch.solve(
        prob, solver="lanczos", kernel="pallas", dtype=torch.float32,
        device="cpu", nev=NEV, tol=1e-8, maxiter=260,
    )
    assert res.converged and res.residuals.max() <= 1e-8
    np.testing.assert_allclose(res.eigenvalues, discrete[:NEV], rtol=1e-8)
    assert {"setup_s", "device_solve_s", "refine_s"} <= set(res.timings)
