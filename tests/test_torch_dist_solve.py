"""The distributed LOBPCG of maxwell_tpu_torch (solvers/dist_solve.py)
and the staged `batch` path of lobpcg against the JAX package's on its
8-device CPU mesh, from the same start blocks (the reference's make_block,
carried over as numpy): the same eigenvalues (the Krylov solvers:
test_torch_dist_krylov.py). The reference's own distributed solves run its
"ref" kernel here (its Pallas kernels would run in interpret mode); the
port's union, "pallas" and halo kernels run their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist import partition_problem as ref_partition
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.solvers import Pencil as RefPencil
from maxwell_tpu.solvers.dist_solve import lobpcg_dist as ref_lobpcg_dist
from maxwell_tpu.solvers.lobpcg import lobpcg as ref_lobpcg
from maxwell_tpu.solvers.precond import (
    shifted_cg_preconditioner as ref_shifted_cg,
)
from maxwell_tpu_torch.dist import make_mesh, partition_problem
from maxwell_tpu_torch.kernels import halo, spmm
from maxwell_tpu_torch.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu_torch.solvers import dist_solve
from maxwell_tpu_torch.solvers.dist_solve import (
    lobpcg_dist,
    shift_invert_lanczos_dist,
)
from maxwell_tpu_torch.solvers.lobpcg import lobpcg
from maxwell_tpu_torch.solvers.operator import Pencil
from maxwell_tpu_torch.solvers.precond import shifted_cg_preconditioner
from maxwell_tpu_torch.solvers.trlanczos import thick_restart_lanczos_dist
from maxwell_tpu_torch.utils.checkpoint import load_sharded_state

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


def _start(ref, m, seed=0):
    return np.asarray(ref.make_block(jax.random.PRNGKey(seed), m))


def test_lobpcg_dist_deep_f64_matches_reference(mesh, brick6):
    ref, port = brick6
    want = ref_lobpcg_dist(ref, mesh, nev=3, maxiter=60, tol=1e-8,
                           precond_alpha=15.0)
    got = lobpcg_dist(port, make_mesh(D, "cpu"), nev=3, maxiter=60,
                      tol=1e-8, precond_alpha=15.0, X0=_start(ref, 7))
    assert got.converged and got.residuals.max() <= 1e-8
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-12)
    assert got.eigenvectors.shape == (port.n, 3)
    # eigenvectors in the problem's own order: K x = lambda M x there
    cav = BrickCavity3D(nx=6, ny=6, nz=6)
    R = cav.K @ got.eigenvectors - (cav.M @ got.eigenvectors) * got.eigenvalues
    assert np.abs(R).max() <= 1e-6 * np.abs(cav.K @ got.eigenvectors).max()


@pytest.mark.parametrize("kernel,impl", [("union", "rdma_overlap"),
                                         ("union", "ppermute"),
                                         ("pallas", "rdma")])
def test_lobpcg_dist_shallow_f32_matches_reference(mesh, kernel, impl):
    """The shallow 16x16 rectangle at f32 through the union or blocked-ELL
    pencil and a halo kernel's plain version, against the reference's f32
    distributed solve ("ref" kernel, 8x8 blocks) from the same X0."""
    cav = RectCavity2D(nx=16, ny=16)
    ref = ref_partition(RefRect(nx=16, ny=16), D, block=8, dtype=jnp.float32)
    port = partition_problem(cav, D, kernel=kernel, dtype=torch.float32,
                             halo_impl=impl, device="cpu")
    want = ref_lobpcg_dist(ref, mesh, nev=3, maxiter=60, tol=1e-5,
                           precond_alpha=10.0)
    halo.reset_counts()
    got = lobpcg_dist(port, None, nev=3, maxiter=60, tol=1e-5,
                      precond_alpha=10.0, X0=_start(ref, 7))
    assert got.converged, got.residuals
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=2e-5)
    np.testing.assert_allclose(got.eigenvalues, _dense(cav, 3), rtol=1e-4)
    c = halo.counts()
    assert (c["union_interior_overlap_ref"] > 0) == (impl == "rdma_overlap")
    assert (c["ring_shift_ref"] > 0) == (impl == "rdma")


def test_lobpcg_dist_deflate_q_matches_reference(mesh, brick6):
    """The next pairs above a hard-deflated block (its vectors in the
    problem's own order)."""
    ref, port = brick6
    first = ref_lobpcg_dist(ref, mesh, nev=3, maxiter=60, tol=1e-8,
                            precond_alpha=15.0)
    want = ref_lobpcg_dist(ref, mesh, nev=2, maxiter=60, tol=1e-8,
                           precond_alpha=15.0,
                           deflate_Q=np.asarray(first.eigenvectors))
    got = lobpcg_dist(port, None, nev=2, maxiter=60, tol=1e-8,
                      precond_alpha=15.0,
                      deflate_Q=np.asarray(first.eigenvectors),
                      X0=_start(ref, 6))
    assert got.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-10)
    assert got.eigenvalues.min() > first.eigenvalues.max() * (1 + 1e-6)


def test_lobpcg_dist_staged_batch_matches_reference(mesh, brick6):
    ref, port = brick6
    want = ref_lobpcg_dist(ref, mesh, nev=4, batch=2, maxiter=60, tol=1e-8,
                           precond_alpha=15.0)
    polished = []
    got = lobpcg_dist(port, None, nev=4, batch=2, maxiter=60, tol=1e-8,
                      precond_alpha=15.0,
                      stage_polish=lambda r: polished.append(r) or r)
    assert got.converged and got.residuals.max() <= 1e-8
    assert len(polished) == 2  # the hook sees each stage's block
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-10)
    assert {h["stage"] for h in got.history} == {0, 1}
    assert got.eigenvectors.shape == (port.n, 4)


def test_lobpcg_dist_staged_spectral_raises(brick6):
    """A staged run asks for the caller's preconditioner as the unstaged
    one does: "spectral" on an assembled pencil raises what the reference's
    DistSpectralShift.build raises there (AttributeError)."""
    _, port = brick6
    with pytest.raises(AttributeError, match="DistStencilPencil3D"):
        lobpcg_dist(port, None, nev=4, batch=2, precond="spectral")


def test_lobpcg_dist_staged_passes_precond(monkeypatch, brick6):
    """Every stage of a staged run takes the caller's `precond` (the
    reference passes it through, maxwell_tpu/solvers/dist_solve.py:279).
    On an assembled pencil "auto" is the shifted-CG branch, so the staged
    "auto" run stays bit for bit the "cg" run it was before."""
    _, port = brick6
    seen = []

    def recording(*args, **kwargs):
        seen.append(kwargs.get("precond", "auto"))
        return lobpcg_dist(*args, **kwargs)

    monkeypatch.setattr(dist_solve, "lobpcg_dist", recording)
    runs = {}
    for precond in ("auto", "cg"):
        seen.clear()
        runs[precond] = lobpcg_dist(port, None, nev=4, batch=2, maxiter=60,
                                    tol=1e-8, precond_alpha=15.0,
                                    precond=precond)
        assert seen == [precond, precond]
    a, c = runs["auto"], runs["cg"]
    assert a.converged
    assert np.array_equal(a.eigenvalues, c.eigenvalues)
    assert np.array_equal(a.eigenvectors, c.eigenvectors)


def test_lobpcg_dist_checkpoint_resume(tmp_path, brick6):
    """In-loop saves write one file per shard; without the exit-time file
    a resume reassembles them and goes on from their iteration (the
    reference's tests/unit/test_checkpoint.py:102)."""
    _, port = brick6
    ckpt = str(tmp_path / "dist.npz")
    partial = lobpcg_dist(port, None, nev=4, maxiter=5, tol=1e-12,
                          precond_alpha=15.0, checkpoint=ckpt,
                          checkpoint_every=2)
    assert not partial.converged and partial.iterations == 5
    ss = load_sharded_state(ckpt, port.D)
    assert ss["X"].shape == (port.global_rows, 8) and ss["iteration"] == 4
    (tmp_path / "dist.npz").unlink()
    resumed = lobpcg_dist(port, None, nev=4, maxiter=120, tol=1e-9,
                          precond_alpha=15.0, checkpoint=ckpt)
    assert resumed.converged
    assert resumed.history[0]["iter"] == 4
    # the exit-time file holds the whole block in the problem's order
    again = lobpcg_dist(port, None, nev=4, maxiter=120, tol=1e-9,
                        precond_alpha=15.0, checkpoint=ckpt)
    assert again.converged and again.iterations >= resumed.iterations


def test_lobpcg_single_device_staged_batch_matches_reference():
    """The staged `batch` path of the one-device lobpcg: two stages of two
    pairs, the second hard-deflated against the first."""
    ref_cav = RefBrick(nx=5, ny=5, nz=5)
    rp = RefPencil.from_problem(ref_cav, dtype=jnp.float64)
    want = ref_lobpcg(rp, nev=4, batch=2, maxiter=80, tol=1e-9,
                      precond=ref_shifted_cg(rp, alpha=10.0, iters=20))
    pp = Pencil.from_problem(BrickCavity3D(nx=5, ny=5, nz=5),
                             dtype=torch.float64, device="cpu")
    spmm.reset_counts()
    got = lobpcg(pp, nev=4, batch=2, maxiter=80, tol=1e-9,
                 precond=shifted_cg_preconditioner(pp, alpha=10.0, iters=20))
    assert got.converged and got.residuals.max() <= 1e-9
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-10)
    assert [h["stage"] for h in got.history][-1] == 1
    assert got.eigenvectors.shape == (pp.n, 4)


def test_unported_distributed_paths_raise(brick6):
    from maxwell_tpu.solvers.spectral import DistSpectralShift as RefShift

    ref, port = brick6
    # the distributed spectral solve serves slab-sharded stencil pencils:
    # on an assembled pencil the reference's build raises AttributeError
    with pytest.raises(AttributeError):
        RefShift.build(ref, 15.0)
    with pytest.raises(AttributeError):
        lobpcg_dist(port, None, nev=2, precond="spectral")
    # the distributed shift-invert runs (test_torch_si_dist.py); a mesh of
    # another shard count is still refused
    with pytest.raises(ValueError, match="shards"):
        shift_invert_lanczos_dist(port, make_mesh(4, "cpu"), sigma=1.0)
    with pytest.raises(ValueError, match="shards"):
        thick_restart_lanczos_dist(port, make_mesh(4, "cpu"),
                                   mode="shift_invert")
    with pytest.raises(ValueError, match="shards"):
        lobpcg_dist(port, make_mesh(4, "cpu"), nev=2)
