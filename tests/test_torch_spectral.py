"""maxwell_tpu_torch.solvers.spectral against maxwell_tpu.solvers.spectral:
the same per-axis bases, `solve` and `solve_sigma` on the same numpy
inputs at f64 (held to 1e-10 of max |reference|), the exact-inverse
property on the port's own pencil, and the preconditioner's pencil checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.problems.stencil3d import StencilPencil3D as RefStencil3D
from maxwell_tpu.solvers.spectral import SpectralShiftSolver as RefSolver
from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
from maxwell_tpu_torch.solvers.spectral import (
    SpectralShiftSolver,
    spectral_preconditioner,
)

torch.set_num_threads(1)

BOX = dict(a=1.0, b=0.8, c=1.3)


def _solvers(dims, alpha, n_padded):
    args = (BOX["a"], BOX["b"], BOX["c"], *dims, alpha, n_padded)
    return (RefSolver.build(*args, dtype=jnp.float64),
            SpectralShiftSolver.build(*args, dtype=torch.float64,
                                      device="cpu"))


def _rhs(n_padded, m, seed):
    return np.random.default_rng(seed).standard_normal((n_padded, m))


@pytest.mark.parametrize("dims", [(6, 5, 4), (8, 8, 8)])
def test_bases_match_reference(dims):
    ref, port = _solvers(dims, 7.5, 1024)
    for k in ("Sx", "Sy", "Sz", "Ux", "Uy", "Uz", "sigx", "sigy", "sigz"):
        np.testing.assert_allclose(getattr(port, k).numpy(),
                                   np.asarray(getattr(ref, k)), atol=1e-14)
    assert port.n == ref.n


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("dims", [(6, 5, 4), (8, 8, 8)])
def test_solve_matches_reference(dims, m):
    ref, port = _solvers(dims, 7.5, 2048)
    R = _rhs(2048, m, m)
    got = port.solve(torch.from_numpy(R)).numpy()
    want = np.asarray(ref.solve(jnp.asarray(R)))
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert not got[port.n:].any()


@pytest.mark.parametrize("dims", [(6, 5, 4), (8, 8, 8)])
def test_solve_sigma_matches_reference(dims):
    ref, port = _solvers(dims, 0.0, 2048)
    R = _rhs(2048, 3, 5)
    sigma = np.array([5.0, 17.3, 40.0])
    got = port.solve_sigma(torch.from_numpy(R), torch.from_numpy(sigma))
    want = np.asarray(ref.solve_sigma(jnp.asarray(R), jnp.asarray(sigma)))
    assert np.abs(got.numpy() - want).max() <= 1e-10 * np.abs(want).max()


def test_from_reference_solves_identically():
    ref, port = _solvers((5, 4, 3), 3.0, 512)
    carried = SpectralShiftSolver.from_reference(ref, device="cpu")
    R = torch.from_numpy(_rhs(512, 2, 7))
    np.testing.assert_array_equal(carried.solve(R).numpy(),
                                  port.solve(R).numpy())


@pytest.mark.parametrize("dims", [(5, 4, 3), (4, 4, 4)])
def test_solve_is_exact_inverse_on_port_pencil(dims):
    """(K + alpha M) solve(R) == R on the unmasked rows of the port's own
    f64 pencil."""
    pencil = StencilPencil3D.build(**BOX, nx=dims[0], ny=dims[1],
                                   nz=dims[2], dtype=torch.float64,
                                   device="cpu")
    alpha = 7.5
    sol = SpectralShiftSolver.build(*BOX.values(), *dims, alpha,
                                    pencil.n_padded, dtype=torch.float64,
                                    device="cpu")
    R = torch.from_numpy(_rhs(pencil.n_padded, 3, 11)) * pencil.mask[:, None]
    KW, MW = pencil.KM_mm(sol.solve(R))
    np.testing.assert_allclose((KW + alpha * MW).numpy(), R.numpy(),
                               rtol=1e-10, atol=1e-10)


def test_preconditioner_checks_the_pencil():
    loaded = StencilPencil3D.build(nx=4, ny=4, nz=4, dtype=torch.float32,
                                   eps_r=np.full((4, 4, 4), 2.0),
                                   device="cpu")
    pc = spectral_preconditioner(loaded, alpha=12.0)
    R = torch.from_numpy(_rhs(loaded.n_padded, 2, 13)).float()
    assert pc(R).shape == R.shape and pc(R).dtype == torch.float32
    pmc = StencilPencil3D.build(nx=4, ny=4, nz=4, dtype=torch.float32,
                                bc="pmc", device="cpu")
    with pytest.raises(ValueError):
        spectral_preconditioner(pmc)
    from maxwell_tpu_torch.problems.stencil2d import StencilPencil2D

    with pytest.raises(ValueError):
        spectral_preconditioner(StencilPencil2D.build(nx=4, ny=4,
                                                      device="cpu"))


def test_preconditioner_matches_reference_f32():
    from maxwell_tpu.solvers.spectral import (
        spectral_preconditioner as ref_precond,
    )

    ref = RefStencil3D.build(nx=6, ny=6, nz=6, dtype=jnp.float32)
    port = StencilPencil3D.build(nx=6, ny=6, nz=6, dtype=torch.float32,
                                 device="cpu")
    R = _rhs(port.n_padded, 3, 17).astype(np.float32)
    got = spectral_preconditioner(port, 15.0)(torch.from_numpy(R)).numpy()
    want = np.asarray(ref_precond(ref, 15.0)(jnp.asarray(R)))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
