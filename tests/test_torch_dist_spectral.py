"""DistSpectralShift of maxwell_tpu_torch (solvers/spectral.py), the
distributed spectral (K + alpha M)^-1 on the slab-sharded stencil pencil,
against the JAX package's on its 8-device CPU mesh at the reference's
oracle size (16 x 5 x 4 cells in 8 slabs): the build's matrices, the
exactness of the solve on the owned rows (1e-10, as the reference's own
test), solve and solve_sigma against the reference's shard_map solves, the
refusals, and lobpcg_dist's choice of preconditioner (staged runs too) and
its checkpoints on the slab pencil."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist import partition_problem as ref_partition
from maxwell_tpu.dist.stencil_dist import (
    DistStencilPencil3D as RefDistStencil,
)
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.solvers.dist_solve import lobpcg_dist as ref_lobpcg_dist
from maxwell_tpu.solvers.spectral import DistSpectralShift as RefShift
from maxwell_tpu_torch.dist import make_mesh, partition_problem
from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
from maxwell_tpu_torch.problems import BrickCavity3D
from maxwell_tpu_torch.solvers import precond as port_precond
from maxwell_tpu_torch.solvers import spectral as port_spectral
from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist
from maxwell_tpu_torch.solvers.spectral import DistSpectralShift

torch.set_num_threads(1)

D = 8
DIMS = dict(nx=16, ny=5, nz=4, D=D)
ALPHA = 6.0


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    return ref_make_mesh(D)


@pytest.fixture(scope="module")
def pair():
    ref = RefDistStencil.build(a=1.0, b=1.1, c_len=0.9, dtype=jnp.float64,
                               **DIMS)
    port = DistStencilPencil3D.build(a=1.0, b=1.1, c_len=0.9,
                                     dtype=torch.float64, device="cpu",
                                     **DIMS)
    return ref, port


def _masked_block(port, m, seed):
    rng = np.random.default_rng(seed)
    R = port.scatter_vector(rng.standard_normal((port.n_full, m)))
    return R * port.mask.numpy()[:, None]


def test_build_matches_reference(pair):
    ref, port = pair
    want = RefShift.build(ref, ALPHA)
    got = DistSpectralShift.build(port, ALPHA)
    for name in ("Sx_full", "Sy_full", "Sz_full", "Ux", "Uy", "Uz", "sigx",
                 "sigy", "sigz"):
        g = getattr(got, name)
        assert g.dtype == torch.float64, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want,
                                                                    name)))
    for name in ("alpha", "nx", "ny", "nz", "cells"):
        assert getattr(got, name) == getattr(want, name), name


def test_solve_is_exact_on_the_owned_rows(pair):
    """(K + alpha M) applied to the solve's output gives back the input on
    the owned unmasked rows."""
    _, port = pair
    sol = DistSpectralShift.build(port, ALPHA)
    R = port.make_block(3, torch.Generator().manual_seed(3))
    R = R * port.mask[:, None]
    KW, MW = port.KM_mm(sol.solve(port, R))
    back = (KW + ALPHA * MW).numpy()
    w = (port.w_dot * port.mask).numpy() > 0
    np.testing.assert_allclose(back[w], R.numpy()[w], rtol=1e-10,
                               atol=1e-10)


def _ref_solve(ref, mesh, sol, R, sigma=None):
    row = P(ref.axis, None)
    if sigma is None:
        fn = lambda p, s, Rl: s.solve(p, Rl)
        args, specs = (), ()
    else:
        fn = lambda p, s, Rl, sg: s.solve_sigma(p, Rl, sg)
        args, specs = (jnp.asarray(sigma),), (P(),)
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(ref.partition_specs(), sol.partition_specs(), row) + specs,
        out_specs=row, check_vma=False))(ref, sol, jnp.asarray(R), *args))


@pytest.mark.parametrize("kind", ["solve", "solve_sigma"])
def test_solves_match_reference(mesh, pair, kind):
    ref, port = pair
    R = _masked_block(port, 3, 11)
    rsol, psol = RefShift.build(ref, ALPHA), DistSpectralShift.build(port,
                                                                     ALPHA)
    if kind == "solve":
        want = _ref_solve(ref, mesh, rsol, R)
        got = psol.solve(port, torch.from_numpy(R)).numpy()
    else:
        # per-column shifts away from the symbol eigenvalues
        sigma = np.array([3.0, 17.5, 40.25])
        want = _ref_solve(ref, mesh, rsol, R, sigma)
        got = psol.solve_sigma(port, torch.from_numpy(R),
                               torch.from_numpy(sigma)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * scale)
    # a vector in, a vector out
    if kind == "solve":
        v = psol.solve(port, torch.from_numpy(R[:, 0])).numpy()
        np.testing.assert_allclose(v, got[:, 0], rtol=1e-13, atol=1e-13)


def test_f32_solve_of_an_f64_pencil_works_in_f32(pair):
    """The refinement's inner solve: an f32 solver on an f64 pencil keeps
    f32 throughout."""
    _, port = pair
    sol = DistSpectralShift.build(port, 0.0, dtype=torch.float32)
    R = torch.from_numpy(_masked_block(port, 2, 12).astype(np.float32))
    W = sol.solve_sigma(port, R, torch.tensor([5.0, 9.0]))
    assert W.dtype == torch.float32
    W64 = DistSpectralShift.build(port, 0.0).solve_sigma(
        port, R.double(), torch.tensor([5.0, 9.0], dtype=torch.float64))
    assert (W.double() - W64).abs().max() <= 1e-5 * W64.abs().max()


def test_build_refusals_match_reference(pair):
    rng = np.random.default_rng(5)
    eps_r = 1.0 + rng.random((16, 5, 4))
    ref_mat = RefDistStencil.build(dtype=jnp.float64, eps_r=eps_r, **DIMS)
    port_mat = DistStencilPencil3D.build(dtype=torch.float64, eps_r=eps_r,
                                         device="cpu", **DIMS)
    with pytest.raises(ValueError, match="vacuum-only"):
        RefShift.build(ref_mat, ALPHA)
    with pytest.raises(ValueError, match="vacuum-only"):
        DistSpectralShift.build(port_mat, ALPHA)
    # an assembled row-sharded pencil: the reference's build raises
    # AttributeError (it has no materials fields)
    ref_asm = ref_partition(RefBrick(nx=4, ny=4, nz=4), D,
                            dtype=jnp.float64)
    port_asm = partition_problem(BrickCavity3D(nx=4, ny=4, nz=4), D,
                                 dtype=torch.float64, device="cpu")
    with pytest.raises(AttributeError):
        RefShift.build(ref_asm, ALPHA)
    with pytest.raises(AttributeError):
        DistSpectralShift.build(port_asm, ALPHA)
    with pytest.raises(AttributeError):
        lobpcg_dist(port_asm, None, nev=2, precond="spectral")


def test_lobpcg_dist_spectral_matches_reference(mesh, pair, monkeypatch):
    """precond="auto" on the slab pencil takes DistSpectralShift (alpha 15
    when precond_alpha is None), from the reference's start block: the
    reference's eigenvalues, and no shifted-CG sweeps."""
    ref, port = pair
    want = ref_lobpcg_dist(ref, mesh, nev=3, maxiter=60, tol=1e-9)
    X0 = np.asarray(ref.make_block(jax.random.PRNGKey(0), 7))
    built = []
    real_build = DistSpectralShift.build
    monkeypatch.setattr(DistSpectralShift, "build", staticmethod(
        lambda sp, alpha, dtype=None: built.append(alpha)
        or real_build(sp, alpha, dtype)))
    monkeypatch.setattr(port_precond, "shifted_cg_preconditioner",
                        lambda *a, **k: pytest.fail("shifted CG taken"))
    got = lobpcg_dist(port, make_mesh(D, "cpu"), nev=3, maxiter=60,
                      tol=1e-9, X0=X0)
    assert built == [15.0]
    assert got.converged and want.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues,
                               rtol=1e-10)
    assert got.iterations <= want.iterations + 2


def test_lobpcg_dist_precond_choice_by_pencil_type(pair, monkeypatch):
    """"cg" forces the shifted-CG sweeps on the slab pencil; "auto" on a
    loaded slab pencil takes them too (the spectral solve is vacuum-only)."""
    _, port = pair
    taken = []
    real = port_precond.shifted_cg_preconditioner
    monkeypatch.setattr(port_precond, "shifted_cg_preconditioner",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    monkeypatch.setattr(port_spectral.DistSpectralShift, "build",
                        staticmethod(lambda *a, **k: pytest.fail("spectral")))
    lobpcg_dist(port, None, nev=2, maxiter=2, tol=1e-9, precond="cg",
                precond_alpha=15.0)
    loaded = DistStencilPencil3D.build(
        dtype=torch.float64, eps_r=np.full((16, 5, 4), 2.0), device="cpu",
        **DIMS)
    lobpcg_dist(loaded, None, nev=2, maxiter=2, tol=1e-9, precond="auto",
                precond_alpha=15.0)
    assert taken == [1, 1]


def test_staged_lobpcg_dist_builds_the_spectral_solve_each_stage(
        pair, monkeypatch):
    """A staged run (batch < nev) on the slab pencil passes "auto" on to
    every stage, and each stage takes DistSpectralShift (F1 on the
    distributed stencil road); the stages' pairs are the dense ones."""
    _, port = pair
    built = []
    real_build = DistSpectralShift.build
    monkeypatch.setattr(DistSpectralShift, "build", staticmethod(
        lambda sp, alpha, dtype=None: built.append(alpha)
        or real_build(sp, alpha, dtype)))
    staged = lobpcg_dist(port, None, nev=4, batch=2, maxiter=80, tol=1e-9)
    assert built == [15.0, 15.0]
    whole = lobpcg_dist(port, None, nev=4, maxiter=80, tol=1e-9)
    assert staged.converged and whole.converged
    np.testing.assert_allclose(staged.eigenvalues, whole.eigenvalues,
                               rtol=1e-8)


def test_lobpcg_dist_checkpoint_resume_on_the_slab_pencil(pair, tmp_path):
    """The exit-time checkpoint holds vectors in the global stencil layout
    and per-slab snapshots the stacked rows; a resume from either
    reassembles the block and converges to the same pairs."""
    _, port = pair
    path = str(tmp_path / "slab.npz")
    first = lobpcg_dist(port, None, nev=3, maxiter=4, tol=1e-12,
                        checkpoint=path, checkpoint_every=2)
    assert first.eigenvectors.shape == (port.n_full, 3)
    again = lobpcg_dist(port, None, nev=3, maxiter=80, tol=1e-9,
                        checkpoint=path)
    assert again.converged and again.iterations > first.iterations
    os.remove(path)
    shards = lobpcg_dist(port, None, nev=3, maxiter=80, tol=1e-9,
                         checkpoint=path)
    assert shards.converged
    np.testing.assert_allclose(shards.eigenvalues, again.eigenvalues,
                               rtol=1e-9)
