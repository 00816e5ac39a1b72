"""Distributed shift-invert of maxwell_tpu_torch (shift_invert_lanczos_dist
and thick_restart_lanczos_dist(mode="shift_invert"), the MINRES apply on
the stacked pencils) against the JAX package's on its 8-device CPU mesh,
from the reference's own start vector: the 12x12 rectangle in 8 row shards
and the 8x5x5 brick in 8 slabs (the reference's tests/distributed/
test_si_dist.py cases), to rtol 1e-7 against the reference and the dense
discrete spectrum; and the one-device port on the same problem."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist import partition_problem as ref_partition
from maxwell_tpu.dist.stencil_dist import DistStencilPencil3D as RefSlabs
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.solvers.dist_solve import (
    shift_invert_lanczos_dist as ref_si_dist,
)
from maxwell_tpu.solvers.trlanczos import (
    thick_restart_lanczos_dist as ref_trl_dist,
)
from maxwell_tpu_torch.dist import make_mesh, partition_problem
from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
from maxwell_tpu_torch.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu_torch.solvers.dist_solve import shift_invert_lanczos_dist
from maxwell_tpu_torch.solvers.operator import Pencil
from maxwell_tpu_torch.solvers.shift_invert import shift_invert_lanczos
from maxwell_tpu_torch.solvers.trlanczos import thick_restart_lanczos_dist

torch.set_num_threads(1)

D = 8


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    return ref_make_mesh(D)


@pytest.fixture(scope="module")
def rect():
    cav = RectCavity2D(nx=12, ny=12)
    ref = ref_partition(RefRect(nx=12, ny=12), D, block=8,
                        dtype=jnp.float64, reorder=True)
    port = partition_problem(cav, D, block=8, dtype=torch.float64,
                             device="cpu")
    v0 = np.asarray(ref.make_block(jax.random.PRNGKey(0), 1))[:, 0]
    return cav, ref, port, v0, _discrete(cav)


def _discrete(cav):
    w = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(), eigvals_only=True)
    return np.sort(w[w > 1e-8])


def _nearest(vals, sigma, k):
    return np.sort(vals[np.argsort(np.abs(vals - sigma))[:k]])


def test_si_dist_interior_modes(mesh, rect):
    """Interior modes near sigma 45 on the 8-shard rectangle."""
    cav, ref, port, v0, discrete = rect
    want = ref_si_dist(ref, mesh, sigma=45.0, nev=4, maxiter=30, tol=1e-7)
    got = shift_invert_lanczos_dist(port, make_mesh(D, "cpu"), sigma=45.0,
                                    nev=4, maxiter=30, tol=1e-7, v0=v0)
    assert got.converged, got.residuals
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-7)
    np.testing.assert_allclose(np.sort(got.eigenvalues),
                               _nearest(discrete, 45.0, 4), rtol=1e-7)
    # eigenvectors in the problem's own order
    X = got.eigenvectors
    assert X.shape == (port.n, 4)
    R = cav.K @ X - (cav.M @ X) * got.eigenvalues
    assert np.linalg.norm(R, axis=0).max() <= 1e-5 * np.linalg.norm(
        cav.K @ X, axis=0).max()


def test_si_dist_matches_the_one_device_port(rect):
    """The stacked pencil's MINRES apply is the one-device apply on another
    row order: the same eigenvalues as shift_invert_lanczos(backend=
    "iterative") on the one-device pencil, from the same start vector."""
    cav, _, port, v0, _ = rect
    got = shift_invert_lanczos_dist(port, None, sigma=45.0, nev=4,
                                    maxiter=30, tol=1e-7, v0=v0)
    one = Pencil.from_problem(cav, block=8, dtype=torch.float64,
                              device="cpu")
    v_one = port.extract_vectors(v0[:, None])[:, 0]
    want = shift_invert_lanczos(one, sigma=45.0, nev=4, maxiter=30,
                                tol=1e-7, backend="iterative", v0=v_one)
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-9)


def test_trlanczos_dist_shift_invert(mesh, rect):
    """thick_restart_lanczos_dist(mode="shift_invert"): small ncv forces
    restarts."""
    _, ref, port, v0, discrete = rect
    kw = dict(nev=4, ncv=14, max_restarts=20, tol=1e-7, sigma=45.0)
    want = ref_trl_dist(ref, mesh, mode="shift_invert", **kw)
    got = thick_restart_lanczos_dist(port, None, mode="shift_invert", v0=v0,
                                     **kw)
    assert got.converged and got.iterations > 14
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-7)
    np.testing.assert_allclose(got.eigenvalues, _nearest(discrete, 45.0, 4),
                               rtol=1e-7)


def test_si_dist_stencil3d(mesh):
    """The slab-sharded 8x5x5 brick in 8 slabs: sigma 60 takes the
    degenerate 61.94 pair, which needs an M-self-adjoint projected
    operator."""
    ref = RefSlabs.build(nx=8, ny=5, nz=5, D=D, dtype=jnp.float64)
    port = DistStencilPencil3D.build(nx=8, ny=5, nz=5, D=D,
                                     dtype=torch.float64, device="cpu")
    v0 = np.asarray(ref.make_block(jax.random.PRNGKey(0), 1))[:, 0]
    want = ref_si_dist(ref, mesh, sigma=60.0, nev=3, maxiter=45, tol=1e-7)
    got = shift_invert_lanczos_dist(port, None, sigma=60.0, nev=3,
                                    maxiter=45, tol=1e-7, v0=v0)
    assert got.converged, got.residuals
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-7)
    discrete = _discrete(BrickCavity3D(nx=8, ny=5, nz=5))
    np.testing.assert_allclose(np.sort(got.eigenvalues),
                               _nearest(discrete, 60.0, 3), rtol=1e-7)
    assert got.eigenvectors.shape == (port.n_full, 3)
