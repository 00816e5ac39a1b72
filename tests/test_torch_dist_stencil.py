"""The slab-sharded matrix-free pencil of maxwell_tpu_torch
(dist/stencil_dist.py) against the JAX package's on its 8-device CPU mesh,
at the reference's own oracle size (16 x 5 x 4 cells in 8 slabs,
tests/distributed/test_stencil_dist.py): build's arrays field for field,
the layout maps, the K/M/KM slab applies (the reference's shard_map apply;
f64 at its own 1e-12, f32 at 1e-5 of max|ref|), materials, the tap kernel
K4's route on ghost-extended slabs (its index math through the kernel's
plain version), the projector, the distributed solvers on the pencil
against dense eigh, and the f32 LOBPCG run past its floor as the scaling
rows run it, from the reference's side too."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from jax.sharding import PartitionSpec as P

from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist.stencil_dist import (
    DistStencilPencil3D as RefDistStencil,
)
from maxwell_tpu.solvers.dist_solve import lobpcg_dist as ref_lobpcg_dist
from maxwell_tpu_torch.dist import make_mesh
from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
from maxwell_tpu_torch.kernels import stencil_taps as kst
from maxwell_tpu_torch.problems import BrickCavity3D
from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
from maxwell_tpu_torch.solvers.dist_solve import lanczos_dist, lobpcg_dist
from maxwell_tpu_torch.solvers.trlanczos import thick_restart_lanczos_dist

torch.set_num_threads(1)

D = 8
NX, NY, NZ = 16, 5, 4
DIMS = dict(nx=NX, ny=NY, nz=NZ, D=D)
TORCH = {"f64": torch.float64, "f32": torch.float32}
JNP = {"f64": jnp.float64, "f32": jnp.float32}
NP = {"f64": np.float64, "f32": np.float32}


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    return ref_make_mesh(D)


def _materials():
    rng = np.random.default_rng(5)
    return (1.0 + rng.random((NX, NY, NZ)), 1.0 + rng.random((NX, NY, NZ)))


def _pair(dt, materials=False):
    eps_r, mu_r = _materials() if materials else (None, None)
    ref = RefDistStencil.build(a=1.0, b=1.1, c_len=0.9, dtype=JNP[dt],
                               eps_r=eps_r, mu_r=mu_r, **DIMS)
    port = DistStencilPencil3D.build(a=1.0, b=1.1, c_len=0.9, dtype=TORCH[dt],
                                     eps_r=eps_r, mu_r=mu_r, device="cpu",
                                     **DIMS)
    return ref, port


@pytest.fixture(scope="module")
def pencils():
    return {key: _pair(*key) for key in
            (("f64", False), ("f32", False), ("f64", True))}


def _ref_apply(ref, mesh, X, which):
    def body(p, Xl):
        if which == "KM":
            return p.KM_mm(Xl)
        return p.K_mm(Xl) if which == "K" else p.M_mm(Xl)

    row = P(ref.axis, None)
    out = row if which != "KM" else (row, row)
    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(ref.partition_specs(), row),
        out_specs=out, check_vma=False))(ref, jnp.asarray(X))


def _port_apply(port, X, which):
    Xt = torch.from_numpy(X)
    if which == "KM":
        return port.KM_mm(Xt)
    return port.K_mm(Xt) if which == "K" else port.M_mm(Xt)


ARRAYS = ("mask", "w_dot", "Ke", "Me", "node_mask", "node_w", "inv_mu",
          "eps", "fpVx_full", "fpVy", "fpVz", "fp_inv_lam")
SCALARS = ("ax", "by", "cz", "nx", "ny", "nz", "cells", "D", "n_loc",
           "n_loc_pad", "nn_loc", "mass_tol", "mass_iters", "proj_tol",
           "proj_iters", "taps", "taps_dw", "global_rows", "n_full")


@pytest.mark.parametrize("key", [("f64", False), ("f32", False),
                                 ("f64", True)],
                         ids=["f64", "f32", "f64-materials"])
def test_build_matches_reference_field_for_field(pencils, key):
    ref, port = pencils[key]
    for name in ARRAYS:
        r, p = getattr(ref, name), getattr(port, name)
        assert (r is None) == (p is None), name
        if r is not None:
            assert p.dtype == TORCH[key[0]], name
            np.testing.assert_array_equal(p.numpy(), np.asarray(r),
                                          err_msg=name)
    for name in SCALARS:
        assert getattr(port, name) == getattr(ref, name), name
    # the K4 route's extended mask: own planes the slab's mask, ghost
    # planes the copied plane's mask, zero at the chain ends
    if port.taps is None:
        assert port.ext_mask is None
    else:
        M = torch.ones((port.global_rows, 1), dtype=port.dtype)
        own = port._owned(port._ext_block(M) * port.ext_mask[..., None])
        np.testing.assert_array_equal(own[:, 0].numpy(), port.mask.numpy())
        ends = port._ext_block(port.mask[:, None])[..., 0]
        np.testing.assert_array_equal(port.ext_mask.numpy(), ends.numpy())


def test_scatter_gather_round_trip_bit_for_bit(pencils):
    ref, port = pencils[("f64", False)]
    rng = np.random.default_rng(1)
    Xg = rng.standard_normal((port.n_full, 2))
    Xs = port.scatter_vector(Xg)
    np.testing.assert_array_equal(Xs, ref.scatter_vector(Xg))
    np.testing.assert_array_equal(port.gather_vector(Xs), Xg)
    np.testing.assert_array_equal(port.extract_vectors(torch.from_numpy(Xs)),
                                  Xg)
    np.testing.assert_array_equal(port.inject_vectors(Xg).numpy(), Xs)
    np.testing.assert_array_equal(port.inject_vectors(Xg[:, 0]).numpy(),
                                  Xs[:, 0])


def test_make_block_keeps_interface_copies(pencils):
    _, port = pencils[("f64", False)]
    X = port.make_block(3, torch.Generator().manual_seed(7))
    back = port.scatter_vector(port.gather_vector(X.numpy()))
    np.testing.assert_array_equal(back, X.numpy())  # copies agree, pad 0
    again = port.make_block(3, torch.Generator().manual_seed(7))
    assert torch.equal(X, again)


@pytest.mark.parametrize("which", ["K", "M", "KM"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_slab_apply_matches_reference(mesh, pencils, which, dt):
    ref, port = pencils[(dt, False)]
    rng = np.random.default_rng(0)
    X = port.scatter_vector(rng.standard_normal((port.n_full, 3))).astype(
        NP[dt])
    want = _ref_apply(ref, mesh, X, which)
    got = _port_apply(port, X, which)
    if which != "KM":
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if dt == "f64":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
        else:
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("which", ["K", "M", "KM"])
def test_materials_slab_apply_matches_reference(mesh, pencils, which):
    ref, port = pencils[("f64", True)]
    rng = np.random.default_rng(5)
    X = port.scatter_vector(rng.standard_normal((port.n_full, 2)))
    want = _ref_apply(ref, mesh, X, which)
    got = _port_apply(port, X, which)
    if which != "KM":
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_slab_apply_matches_the_single_device_pencil(pencils, dt):
    """Gathered to the global layout, the slab apply is the one-device
    tap apply (bit for bit: the same taps in the same order)."""
    _, port = pencils[(dt, False)]
    one = StencilPencil3D.build(a=1.0, b=1.1, c=0.9, nx=NX, ny=NY, nz=NZ,
                                dtype=TORCH[dt], device="cpu")
    rng = np.random.default_rng(2)
    Xg = rng.standard_normal((port.n_full, 2))
    Xf = torch.zeros((one.n_padded, 2), dtype=TORCH[dt])
    Xf[: one.n] = torch.from_numpy(Xg)
    KS, MS = port.KM_mm(port.inject_vectors(Xg))
    K1, M1 = one.KM_mm(Xf)
    for s, o in ((KS, K1), (MS, M1)):
        np.testing.assert_array_equal(port.extract_vectors(s),
                                      o[: one.n].numpy())


@pytest.mark.parametrize("m", [1, 3, 171])
@pytest.mark.parametrize("which", ["K", "M", "KM"])
def test_k4_route_index_math_on_the_cpu(pencils, m, which):
    """The tap kernel's route: each slab's ghost-extended block, a brick of
    (cells + 2, ny, nz) cells, through the kernel's plain version with the
    extended mask, then the owned planes, equals the plain slab apply; one
    call a slab."""
    _, port = pencils[("f32", False)]
    assert port.ext_shape == (NX // D + 2, NY, NZ)
    rng = np.random.default_rng(m)
    # random on every row, padding and masked rows too
    X = torch.from_numpy(
        rng.standard_normal((port.global_rows, m)).astype(np.float32))
    want_K, want_M = "K" in which, "M" in which
    kst.reset_counts()
    got = port._taps_apply_ext(X, want_K, want_M)
    assert kst.counts() == {"stencil_taps": 0, "stencil_taps_ref": D}
    want = port._taps_apply_plain(X, want_K, want_M)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_cpu_apply_takes_the_plain_version(pencils):
    """On the CPU the slab apply runs the plain version: no kernel launch
    and no call of the kernel's plain version."""
    _, port = pencils[("f32", False)]
    kst.reset_counts()
    port.KM_mm(port.make_block(2))
    assert kst.counts() == {"stencil_taps": 0, "stencil_taps_ref": 0}


@pytest.mark.parametrize("key", [("f64", False), ("f64", True)],
                         ids=["vacuum", "materials"])
def test_project_matches_reference(mesh, pencils, key):
    """Exact fast nodal solve (vacuum) and nodal CG (materials)."""
    ref, port = pencils[key]
    rng = np.random.default_rng(3)
    X = port.scatter_vector(rng.standard_normal((port.n_full, 3)))
    row = P(ref.axis, None)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda p, Xl: p.project(Xl), mesh=mesh,
        in_specs=(ref.partition_specs(), row), out_specs=row,
        check_vma=False))(ref, jnp.asarray(X)))
    got = port.project(torch.from_numpy(X)).numpy()
    if port.fpVx_full is not None:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    else:
        # both stop their nodal CG at proj_tol (1e-10, relative residual):
        # they agree to what that residual leaves of the solution
        assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()
    # the result is M-orthogonal to the gradients
    Y = torch.from_numpy(got)
    gt = port.node_mask[:, None] * port._gt_mm(port.M_mm(Y))
    assert gt.abs().max() <= 1e-8 * port.M_mm(Y).abs().max()


def test_reductions_match_reference(mesh, pencils):
    ref, port = pencils[("f64", False)]
    rng = np.random.default_rng(4)
    A = port.scatter_vector(rng.standard_normal((port.n_full, 3)))
    B = port.scatter_vector(rng.standard_normal((port.n_full, 3)))
    row = P(ref.axis, None)
    ref_mm, ref_cols = jax.jit(jax.shard_map(
        lambda p, a, b: (p.dot_mm(a, b), p.dot_cols(a, b)), mesh=mesh,
        in_specs=(ref.partition_specs(), row, row), out_specs=(P(), P()),
        check_vma=False))(ref, jnp.asarray(A), jnp.asarray(B))
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    np.testing.assert_allclose(port.dot_mm(At, Bt).numpy(),
                               np.asarray(ref_mm), rtol=1e-12)
    np.testing.assert_allclose(port.dot_cols(At, Bt).numpy(),
                               np.asarray(ref_cols), rtol=1e-12)
    np.testing.assert_allclose(
        port.dot_vv(At[:, 0], Bt[:, 0]).item(), np.asarray(ref_cols)[0],
        rtol=1e-12)
    # on masked vectors the weighted inner product is the global one
    mk = port.mask.numpy()[:, None]
    np.testing.assert_allclose(
        port.dot_mm(At * mk, Bt * mk).numpy(),
        port.gather_vector(A * mk).T @ port.gather_vector(B * mk),
        rtol=1e-12)


def _discrete(nx, ny, nz, k, a=1.0, b=1.0, c=1.0):
    cav = BrickCavity3D(a=a, b=b, c=c, nx=nx, ny=ny, nz=nz)
    w = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(), eigvals_only=True)
    return np.sort(w[w > 1e-8])[:k]


def test_lobpcg_dist_f64_matches_dense_eigh(pencils):
    _, port = pencils[("f64", False)]
    res = lobpcg_dist(port, make_mesh(D, "cpu"), nev=3, maxiter=80,
                      tol=1e-8, precond_alpha=15.0)
    assert res.converged, f"residuals {res.residuals}"
    np.testing.assert_allclose(res.eigenvalues,
                               _discrete(NX, NY, NZ, 3, 1.0, 1.1, 0.9),
                               rtol=1e-7)
    assert res.eigenvectors.shape == (port.n_full, 3)


def test_lanczos_dist_on_the_slab_pencil():
    """The distributed Lanczos on a tiny slab pencil (plain Lanczos needs
    a near-complete Krylov space for the smallest modes)."""
    port = DistStencilPencil3D.build(nx=8, ny=3, nz=3, D=D,
                                     dtype=torch.float64, device="cpu")
    res = lanczos_dist(port, make_mesh(D, "cpu"), nev=3, maxiter=330,
                       tol=1e-8)
    assert res.converged, f"residuals {res.residuals}"
    np.testing.assert_allclose(res.eigenvalues, _discrete(8, 3, 3, 3),
                               rtol=1e-8)
    assert res.eigenvectors.shape == (port.n_full, 3)


def test_thick_restart_lanczos_dist_on_the_slab_pencil():
    port = DistStencilPencil3D.build(nx=8, ny=3, nz=3, D=D,
                                     dtype=torch.float64, device="cpu")
    res = thick_restart_lanczos_dist(port, make_mesh(D, "cpu"), nev=3,
                                     ncv=40, max_restarts=60, tol=1e-8)
    assert res.converged, f"residuals {res.residuals}"
    np.testing.assert_allclose(res.eigenvalues, _discrete(8, 3, 3, 3),
                               rtol=1e-8)


FLOOR_START_H100 = Path(__file__).parent / "data" / "scaling16_start_h100.npz"


@pytest.mark.parametrize("start", ["h100", 2, 4, 8])
def test_lobpcg_dist_f32_stays_at_its_floor(mesh, start, monkeypatch):
    """The scaling rows' solve (bench/scaling.py: the 16^3 vacuum brick in
    2 slabs, f32, nev 4, alpha 15, tol 1e-30, 40 iterations) in both
    packages from one start block: the port's make_block on an H100
    (NVIDIA H100 80GB HBM3), where the port's row broke down (0.958), or
    on the CPU from seed 2, 4 or 8, where it broke down on one thread
    (0.96-1.0) before LOBPCG restarted without P on an ill-conditioned
    basis. The reference's block (its P masked) never broke down from
    these blocks. Both reach the f32 floor and stay there."""
    port = DistStencilPencil3D.build(nx=16, ny=16, nz=16, D=2,
                                     dtype=torch.float32, device="cpu")
    if start == "h100":
        X0 = np.load(FLOOR_START_H100)["X0"]
    else:
        X0 = port.make_block(8, torch.Generator().manual_seed(start)).numpy()
    kw = dict(nev=4, maxiter=40, tol=1e-30, precond_alpha=15.0)
    got = lobpcg_dist(port, make_mesh(2, "cpu"), X0=X0, **kw)
    monkeypatch.setattr(RefDistStencil, "make_block",
                        lambda self, key, m: jnp.asarray(X0[:, :m]))
    ref = RefDistStencil.build(nx=16, ny=16, nz=16, D=2, dtype=jnp.float32)
    want = ref_lobpcg_dist(ref, ref_make_mesh(2), **kw)
    for res in (got, want):
        hist = [h["max_rel_res"] for h in res.history]
        assert len(hist) == 40
        assert min(hist) < 1e-5
        assert max(hist[-10:]) < 1e-4, hist[-10:]
    assert got.history[0]["max_rel_res"] == pytest.approx(
        want.history[0]["max_rel_res"], rel=1e-5)


def test_build_refuses_a_width_the_slabs_do_not_divide():
    with pytest.raises(ValueError, match="divisible"):
        DistStencilPencil3D.build(nx=10, ny=3, nz=3, D=4, device="cpu")
