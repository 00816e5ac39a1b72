"""The distributed Krylov solvers of maxwell_tpu_torch (lanczos_dist,
thick_restart_lanczos_dist) against the JAX package's on its 8-device CPU
mesh, from the same start vector (the reference's make_block, carried over
as numpy): the same eigenvalues. The reference's solves run its "ref"
kernel; the port's blocked-ELL SpMV and ring shift run their plain
versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist import partition_problem as ref_partition
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.solvers.dist_solve import lanczos_dist as ref_lanczos_dist
from maxwell_tpu.solvers.trlanczos import (
    thick_restart_lanczos_dist as ref_trl_dist,
)
from maxwell_tpu_torch.dist import partition_problem
from maxwell_tpu_torch.kernels import bsr_spmm, halo
from maxwell_tpu_torch.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu_torch.solvers.dist_solve import lanczos_dist
from maxwell_tpu_torch.solvers.trlanczos import thick_restart_lanczos_dist

torch.set_num_threads(1)

D = 8


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    return ref_make_mesh(D)


@pytest.fixture(scope="module")
def brick6():
    """The deep-halo 6^3 brick at f64 ("ref" kernel), both packages."""
    ref = ref_partition(RefBrick(nx=6, ny=6, nz=6), D, dtype=jnp.float64)
    port = partition_problem(BrickCavity3D(nx=6, ny=6, nz=6), D,
                             dtype=torch.float64, device="cpu")
    return ref, port


def _dense(cav, k):
    w = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(), eigvals_only=True)
    return np.sort(w[w > 1e-8])[:k]


def _start(ref):
    return np.asarray(ref.make_block(jax.random.PRNGKey(0), 1))[:, 0]


def test_lanczos_dist_matches_reference(mesh, brick6):
    ref, port = brick6
    want = ref_lanczos_dist(ref, mesh, nev=3, maxiter=80, tol=1e-8)
    got = lanczos_dist(port, None, nev=3, maxiter=80, tol=1e-8,
                       v0=_start(ref))
    assert got.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-10)


def test_lanczos_dist_pallas_runs_the_spmv():
    """A "pallas" pencil's vector applies go through the blocked-ELL SpMV
    (its plain version here), the halos through the ring shift."""
    cav = RectCavity2D(nx=16, ny=16)
    port = partition_problem(cav, D, kernel="pallas", dtype=torch.float32,
                             halo_impl="rdma", device="cpu")
    bsr_spmm.reset_counts()
    halo.reset_counts()
    got = lanczos_dist(port, None, nev=3, maxiter=100, tol=1e-5)
    # one Krylov vector finds one copy of a double eigenvalue first
    np.testing.assert_allclose(got.eigenvalues[0], _dense(cav, 1), rtol=1e-4)
    assert bsr_spmm.counts()["bsr_matvec_ref"] > 0
    assert halo.counts()["ring_shift_ref"] > 0


def test_trlanczos_dist_matches_reference(mesh, brick6):
    """Small ncv forces thick restarts."""
    ref, port = brick6
    want = ref_trl_dist(ref, mesh, nev=3, ncv=12, max_restarts=60, tol=1e-9)
    got = thick_restart_lanczos_dist(port, None, nev=3, ncv=12,
                                     max_restarts=60, tol=1e-9,
                                     v0=_start(ref))
    assert got.converged and got.iterations > 12
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-9)
