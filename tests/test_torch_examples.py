"""The port's examples (maxwell_tpu_torch/examples/) on the CPU against the
JAX package's own calls on the same arguments (examples/01-04), each held
at the solve's tolerance. The 2D examples run at half their grids (24x17,
16x16) for the time budget; the 3D ones at their own 8^3."""

import jax.numpy as jnp
import numpy as np
import torch

import maxwell_tpu
from maxwell_tpu.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu_torch.examples import (
    cavity_modes,
    dielectric_cavity,
    distributed_solve,
    matrix_free_interior_modes,
)

torch.set_num_threads(1)


def test_cavity_modes():
    out = cavity_modes.main(device="cpu", nx=24, ny=17)
    want = maxwell_tpu.solve(RectCavity2D(a=1.0, b=0.7, nx=24, ny=17),
                             nev=6, tol=1e-9)
    np.testing.assert_allclose(out["computed"], want.eigenvalues, rtol=1e-9)
    assert out["residuals"].max() <= 1e-9
    np.testing.assert_allclose(out["analytic"],
                               RectCavity2D(a=1.0, b=0.7).analytic_eigenvalues(6))
    assert out["rel err"].max() < 2e-2  # O(h^2) at 24x17


def test_dielectric_cavity():
    out = dielectric_cavity.main(device="cpu")
    n = 8
    eps = np.ones((n, n, n))
    eps[: n // 2] = 4.0
    vac = maxwell_tpu.solve(BrickCavity3D(nx=n, ny=n, nz=n), nev=3)
    ld = maxwell_tpu.solve(BrickCavity3D(nx=n, ny=n, nz=n, eps_r=eps),
                           nev=3, precond_alpha=10.0)
    np.testing.assert_allclose(out["vacuum"], vac.eigenvalues, rtol=1e-8)
    np.testing.assert_allclose(out["loaded"], ld.eigenvalues, rtol=1e-8)
    assert out["residuals"].max() <= 1e-8
    assert np.all(out["loaded"] < out["vacuum"])


def test_matrix_free_interior_modes():
    from maxwell_tpu.problems.stencil2d import StencilPencil2D
    from maxwell_tpu.solvers.shift_invert import shift_invert_lanczos

    out = matrix_free_interior_modes.main(device="cpu", n=16)
    stp = StencilPencil2D.build(nx=16, ny=16, dtype=jnp.float64)
    want = shift_invert_lanczos(stp, sigma=45.0, nev=4, maxiter=30,
                                tol=1e-8, backend="iterative")
    got = out["modes near sigma=45"]
    np.testing.assert_allclose(np.sort(got), np.sort(want.eigenvalues),
                               rtol=1e-8)
    assert out["residuals"].max() <= 1e-8


def test_distributed_solve():
    res = distributed_solve.main(device="cpu")
    want = maxwell_tpu.solve(BrickCavity3D(nx=8, ny=8, nz=8), nev=3,
                             distributed=True, n_shards=8, maxiter=80)
    assert res.converged and want.converged
    np.testing.assert_allclose(res.eigenvalues, want.eigenvalues, rtol=1e-8)
    assert res.eigenvectors.shape == (BrickCavity3D(nx=8, ny=8, nz=8).n_edges,
                                      3)
