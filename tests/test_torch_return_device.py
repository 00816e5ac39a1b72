"""The device-resident solve -> refine chain of maxwell_tpu_torch
(`return_device` on lobpcg, refine_dw, lobpcg_dist and refine_dw_dist)
against the host round trip and against the JAX package's own chain, on
the CPU.

Bounds: the device-resident path equals the host path bit for bit (same
start block, same operations; only where the block lives differs); against
the JAX chain on the same start block the refined eigenvalues agree to
1e-10 relative and every residual is <= 1e-8 on both sides (the port's
LOBPCG keeps its P block, unlike the reference's, so the f32 blocks handed
to the refinement differ; the refinement removes the difference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist.stencil_dist import (
    DistStencilPencil3D as RefDistStencil,
)
from maxwell_tpu.problems.stencil3d import StencilPencil3D as RefStencil3D
from maxwell_tpu.solvers import lobpcg as ref_lobpcg
from maxwell_tpu.solvers.dist_solve import lobpcg_dist as ref_lobpcg_dist
from maxwell_tpu.solvers.refine_device import refine_dw as ref_refine_dw
from maxwell_tpu.solvers.refine_device import (
    refine_dw_dist as ref_refine_dw_dist,
)
from maxwell_tpu.solvers.spectral import (
    spectral_preconditioner as ref_precond,
)
from maxwell_tpu_torch.dist import make_mesh
from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
from maxwell_tpu_torch.solvers.dist_solve import host_vectors, lobpcg_dist
from maxwell_tpu_torch.solvers.lobpcg import lobpcg
from maxwell_tpu_torch.solvers.refine_device import refine_dw, refine_dw_dist
from maxwell_tpu_torch.solvers.results import EigenResult
from maxwell_tpu_torch.solvers.spectral import spectral_preconditioner
from maxwell_tpu_torch.utils import twofloat as tf

torch.set_num_threads(1)

N = 8
NEV = 4
SOLVE = dict(nev=NEV, maxiter=60, tol=1e-5, stall_window=10)
DIST = dict(nev=NEV, maxiter=60, tol=1e-5, precond="spectral",
            precond_alpha=15.0, stall_window=10)


@pytest.fixture(scope="module")
def pencil():
    return StencilPencil3D.build(nx=N, ny=N, nz=N, dtype=torch.float32,
                                 device="cpu")


@pytest.fixture(scope="module")
def X0(pencil):
    X = np.zeros((pencil.n_padded, NEV + 4), np.float32)
    X[: pencil.n] = np.random.default_rng(3).standard_normal(
        (pencil.n, NEV + 4))
    return X


@pytest.fixture(scope="module")
def chains(pencil, X0):
    """The port's chain both ways from the same X0: (device, host)."""
    pc = spectral_preconditioner(pencil, 15.0)
    dev = lobpcg(pencil, precond=pc, X0=X0, return_device=True, **SOLVE)
    host = lobpcg(pencil, precond=pc, X0=X0, **SOLVE)
    return dev, host


def test_lobpcg_return_device_is_the_host_block(pencil, chains):
    dev, host = chains
    X = dev.eigenvectors
    assert torch.is_tensor(X) and X.shape == (pencil.n_padded, NEV)
    assert X.device == pencil.device
    assert np.array_equal(X[: pencil.n].numpy(), host.eigenvectors)
    assert not X[pencil.n:].any()  # the padded layout: zero past n
    np.testing.assert_array_equal(dev.eigenvalues, host.eigenvalues)
    np.testing.assert_array_equal(dev.residuals, host.residuals)
    assert isinstance(dev.eigenvalues, np.ndarray)


def test_refine_dw_return_device_is_the_host_path(pencil, chains):
    dev, host = chains
    a = refine_dw(pencil, dev.eigenvectors, tol=1e-8, return_device=True)
    b = refine_dw(pencil, host.eigenvectors, tol=1e-8)
    Xh, Xl = a.eigenvectors
    assert Xh.shape == Xl.shape == (pencil.n_padded, NEV)
    assert Xh.dtype == Xl.dtype == torch.float32
    assert np.array_equal(tf.dw_to_f64(Xh, Xl)[: pencil.n], b.eigenvectors)
    np.testing.assert_array_equal(a.eigenvalues, b.eigenvalues)
    np.testing.assert_array_equal(a.residuals, b.residuals)


def test_refine_dw_takes_the_padded_block_without_a_copy(pencil, chains):
    """An (n_padded, m) f32 block on the pencil's device goes in as it is
    and is left untouched."""
    X = chains[0].eigenvectors
    before = X.clone()
    calls = []
    real = torch.Tensor.new_zeros

    def spy(self, *a, **k):
        calls.append(tuple(a[0]) if a else None)
        return real(self, *a, **k)

    torch.Tensor.new_zeros = spy
    try:
        refine_dw(pencil, X, tol=1e-8, max_sweeps=1)
    finally:
        torch.Tensor.new_zeros = real
    assert (pencil.n_padded, NEV) not in calls
    assert torch.equal(X, before)


def test_chain_matches_the_jax_chain(pencil, chains, X0):
    ref = RefStencil3D.build(nx=N, ny=N, nz=N, dtype=jnp.float32)
    r32 = ref_lobpcg(ref, precond=ref_precond(ref, 15.0),
                     X0=jnp.asarray(X0), return_device=True, **SOLVE)
    assert isinstance(r32.eigenvectors, jax.Array)
    want = ref_refine_dw(ref, r32.eigenvectors, tol=1e-8,
                         return_device=True)
    got = refine_dw(pencil, chains[0].eigenvectors, tol=1e-8,
                    return_device=True)
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues,
                               rtol=1e-10)
    assert got.residuals.max() <= 1e-8 and want.residuals.max() <= 1e-8
    assert isinstance(want.eigenvectors[0], jax.Array)


@pytest.mark.parametrize("D", [1, 2])
def test_dist_chain_matches_the_jax_chain(D):
    """lobpcg_dist -> refine_dw_dist with return_device on the 8^3 brick in
    D slabs, against the reference's chain on its CPU mesh, compared after
    extract_vectors."""
    assert jax.device_count() >= D
    dsp = DistStencilPencil3D.build(nx=N, ny=N, nz=N, D=D,
                                    dtype=torch.float32, device="cpu")
    r32 = lobpcg_dist(dsp, make_mesh(D, "cpu"), return_device=True, **DIST)
    assert torch.is_tensor(r32.eigenvectors)
    assert r32.eigenvectors.shape == (dsp.global_rows, NEV)
    got = refine_dw_dist(dsp, None, r32.eigenvectors, tol=1e-8,
                         return_device=True)
    Xh, Xl = got.eigenvectors
    assert Xh.shape == Xl.shape == (dsp.global_rows, NEV)

    ref = RefDistStencil.build(nx=N, ny=N, nz=N, D=D, dtype=jnp.float32)
    mesh = ref_make_mesh(D)
    w32 = ref_lobpcg_dist(ref, mesh, return_device=True, **DIST)
    want = ref_refine_dw_dist(ref, mesh, w32.eigenvectors, tol=1e-8,
                              return_device=True)
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues,
                               rtol=1e-10)
    assert got.residuals.max() <= 1e-8 and want.residuals.max() <= 1e-8

    # after extract_vectors: the port's pair is its host path bit for bit,
    # and both sides' f64 vectors are eigenvectors of the same pencil
    host = refine_dw_dist(dsp, None,
                          lobpcg_dist(dsp, None, **DIST).eigenvectors,
                          tol=1e-8)
    mine = host_vectors(dsp, got.eigenvectors)
    assert np.array_equal(mine, host.eigenvectors)
    theirs = tf.dw_to_f64(ref.extract_vectors(np.asarray(want.eigenvectors[0])),
                          ref.extract_vectors(np.asarray(want.eigenvectors[1])))
    p64 = StencilPencil3D.build(nx=N, ny=N, nz=N, dtype=torch.float64,
                                device="cpu")
    for X, th in ((mine, got.eigenvalues), (theirs, want.eigenvalues)):
        Xp = torch.zeros((p64.n_padded, NEV), dtype=torch.float64)
        Xp[: p64.n] = torch.from_numpy(X)
        KX, MX = p64.KM_mm(Xp)
        t = torch.from_numpy(th)
        rel = (KX - MX * t).norm(dim=0) / (KX.norm(dim=0)
                                          + t.abs() * MX.norm(dim=0))
        assert rel.max() <= 2e-8, rel


def test_layouts_that_coincide():
    """A brick whose edge count is a multiple of 128: the padded layout
    (n_padded == n) and the D = 1 stacked layout (global_rows == n_full)
    are the problem's own, so a tensor in the problem's ordering is a
    padded or stacked block; the chains give the host paths' results."""
    nx, ny, nz = 7, 7, 3
    p = StencilPencil3D.build(nx=nx, ny=ny, nz=nz, dtype=torch.float32,
                              device="cpu")
    d = DistStencilPencil3D.build(nx=nx, ny=ny, nz=nz, D=1,
                                  dtype=torch.float32, device="cpu")
    assert p.n == p.n_padded == d.n_full == d.global_rows
    r = lobpcg(p, nev=3, maxiter=60, tol=1e-5, stall_window=10,
               precond=spectral_preconditioner(p, 15.0), return_device=True)
    a = refine_dw(p, r.eigenvectors, tol=1e-8, return_device=True)
    b = refine_dw(p, r.eigenvectors.numpy(), tol=1e-8)
    assert np.array_equal(tf.dw_to_f64(*a.eigenvectors), b.eigenvectors)

    rd = lobpcg_dist(d, None, nev=3, maxiter=60, tol=1e-5,
                     precond="spectral", stall_window=10, return_device=True)
    assert np.array_equal(d.extract_vectors(rd.eigenvectors),
                          rd.eigenvectors.numpy())
    a = refine_dw_dist(d, None, rd.eigenvectors, tol=1e-8,
                       return_device=True)
    b = refine_dw_dist(d, None, rd.eigenvectors.numpy(), tol=1e-8)
    assert np.array_equal(host_vectors(d, a.eigenvectors), b.eigenvectors)
    np.testing.assert_array_equal(a.eigenvalues, b.eigenvalues)


def test_staged_paths_ignore_the_flag(pencil):
    pc = spectral_preconditioner(pencil, 15.0)
    r = lobpcg(pencil, nev=4, batch=2, maxiter=40, tol=1e-4, precond=pc,
               return_device=True)
    assert isinstance(r.eigenvectors, np.ndarray)
    assert r.eigenvectors.shape == (pencil.n, 4)
    dsp = DistStencilPencil3D.build(nx=N, ny=N, nz=N, D=2,
                                    dtype=torch.float32, device="cpu")
    rd = lobpcg_dist(dsp, None, nev=4, batch=2, maxiter=40, tol=1e-4,
                     return_device=True)
    assert isinstance(rd.eigenvectors, np.ndarray)
    assert rd.eigenvectors.shape == (dsp.n_full, 4)


def test_stage_polish_may_return_the_device_pair():
    """A stage_polish that keeps its pair on the device: the staged solve
    joins the stages on the host all the same."""
    dsp = DistStencilPencil3D.build(nx=N, ny=N, nz=N, D=2,
                                    dtype=torch.float32, device="cpu")

    def polish(r):
        return refine_dw_dist(dsp, None, r.eigenvectors, tol=1e-8,
                              return_device=True)

    r = lobpcg_dist(dsp, None, nev=4, batch=2, maxiter=60, tol=1e-5,
                    precond="spectral", stall_window=10, stage_polish=polish)
    assert isinstance(r.eigenvectors, np.ndarray)
    assert r.eigenvectors.shape == (dsp.n_full, 4)
    assert r.residuals.max() <= 1e-8


def test_eigen_result_prints_with_device_vectors():
    t = torch.zeros((5, 2))
    for vecs in (t, (t, t.clone())):
        r = EigenResult(eigenvalues=np.array([1.0, 2.0]), eigenvectors=vecs,
                        residuals=np.array([1e-9, 2e-9]), iterations=3,
                        converged=True)
        text = repr(r)
        assert "nev=2" in text and "max_res=2.00e-09" in text
