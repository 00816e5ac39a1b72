"""Shift-invert Lanczos of maxwell_tpu_torch (solvers/shift_invert.py)
against the JAX package's on config 3's 16x16 rectangle, from the same
start vector (the reference's key-0 draw, carried over as numpy): sigma 45
and nev 4 (the LDL^T, splu, auto and MINRES backends) and sigma 1 and nev 5
(LDL^T and splu), against the reference's eigenvalues and golden
`rect2d_16x16` (rtol 1e-8, MINRES 1e-7); the union pencil's to_csr branch at f32; the bellpairs refusal; the
2D stencil pencil with MINRES; solve() and the CLI on config 3."""

import contextlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maxwell_tpu_torch
from maxwell_tpu.cli import run as ref_cli
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.problems.stencil2d import StencilPencil2D as RefStencil2D
from maxwell_tpu.solvers import Pencil as RefPencil
from maxwell_tpu.solvers import shift_invert as ref_si
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.kernels import tri_solve
from maxwell_tpu_torch.problems import RectCavity2D
from maxwell_tpu_torch.problems.golden import golden_eigenvalues
from maxwell_tpu_torch.problems.stencil2d import StencilPencil2D
from maxwell_tpu_torch.solvers import shift_invert
from maxwell_tpu_torch.solvers.operator import Pencil

torch.set_num_threads(1)

CONFIG3 = Path(__file__).resolve().parents[1] / "configs" / "config3.json"
KW = dict(nx=16, ny=16)


@pytest.fixture(scope="module")
def setup():
    cav = RefRect(**KW)
    ref = RefPencil.from_problem(cav, block=8, dtype=jnp.float64)
    prob = RectCavity2D(**KW)
    port = Pencil.from_problem(prob, block=8, dtype=torch.float64,
                               device="cpu")
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (ref.n_padded,),
                                    dtype=jnp.float64))
    v0[ref.n:] = 0.0
    golden, _, _ = golden_eigenvalues("rect2d_16x16")
    return cav, ref, prob, port, v0, golden


def _nearest(vals, sigma, k):
    return np.sort(vals[np.argsort(np.abs(vals - sigma))[:k]])


@pytest.mark.parametrize("sigma,nev,backend", [
    (45.0, 4, "ldlt"), (45.0, 4, "splu"), (45.0, 4, "auto"),
    (1.0, 5, "ldlt"), (1.0, 5, "splu"), (45.0, 4, "iterative"),
])
def test_config3_matches_reference_and_golden(setup, sigma, nev, backend):
    cav, ref, prob, port, v0, golden = setup
    iterative = backend == "iterative"
    maxiter, tol = (30, 1e-7) if iterative else (40, 1e-8)
    want = ref_si.shift_invert_lanczos(ref, sigma=sigma, nev=nev,
                                       maxiter=maxiter, tol=tol,
                                       backend=backend)
    tri_solve.reset_counts()
    got = shift_invert.shift_invert_lanczos(port, sigma=sigma, nev=nev,
                                            maxiter=maxiter, tol=tol,
                                            backend=backend, v0=v0)
    assert got.converged, got.residuals
    assert got.residuals.max() <= tol
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=tol)
    np.testing.assert_allclose(np.sort(got.eigenvalues),
                               _nearest(golden, sigma, nev), rtol=tol)
    assert got.eigenvectors.shape == (port.n, nev)
    # the factored backends solve with two factors an apply, on the CPU
    # through the plain version
    calls = tri_solve.counts()["level_solve_plain"]
    assert calls == (0 if iterative else 2 * maxiter)


def test_union_pencil_factors_its_two_streams_at_f32(setup):
    """The union pencil carries M as K's second value stream: the factored
    matrices come from to_csr("a") and to_csr("b"), and the f32 solve finds
    config 3's modes to 1e-5."""
    _, _, prob, _, v0, golden = setup
    union = Pencil.from_problem(prob, kernel="union", dtype=torch.float32,
                                device="cpu")
    got = shift_invert.shift_invert_lanczos(union, sigma=45.0, nev=4,
                                            maxiter=40, tol=1e-5, v0=v0)
    np.testing.assert_allclose(np.sort(got.eigenvalues),
                               _nearest(golden, 45.0, 4), rtol=1e-5)
    assert got.residuals.max() <= 1e-4


def test_bellpairs_pencil_without_KM_raises(setup):
    cav, _, prob, _, _, _ = setup
    pairs = Pencil.from_problem(prob, kernel="bellpairs", dtype=torch.float32,
                                device="cpu")
    with pytest.raises(ValueError, match="KM="):
        shift_invert.build_shift_invert_op(pairs, 45.0)
    ref_pairs = RefPencil.from_problem(cav, kernel="bellpairs",
                                       dtype=jnp.float32)
    with pytest.raises(ValueError, match="KM="):
        ref_si.build_shift_invert_op(ref_pairs, 45.0)
    # with the assembled matrices it factors
    shift_invert.build_shift_invert_op(pairs, 45.0, KM=(prob.K, prob.M))


def test_auto_falls_back_to_splu_only_on_a_zero_pivot(setup, monkeypatch):
    _, _, prob, port, _, _ = setup

    def zero_pivot(*a, **k):
        raise ZeroDivisionError("zero pivot at column 0")

    monkeypatch.setattr(tri_solve.SparseLDLTDevice, "factor", zero_pivot)
    op = shift_invert.build_shift_invert_op(port, 45.0, backend="auto")
    assert isinstance(op.args[1], tri_solve.SparseLUDevice)
    with pytest.raises(ZeroDivisionError):
        shift_invert.build_shift_invert_op(port, 45.0, backend="ldlt")

    def broken(*a, **k):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(tri_solve.SparseLDLTDevice, "factor", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        shift_invert.build_shift_invert_op(port, 45.0, backend="auto")


def test_iterative_on_the_2d_stencil_pencil():
    """Matrix-free interior modes: the 2D stencil pencil with MINRES (the
    reference's test_iterative_shift_invert_on_stencil, 12x12)."""
    ref = RefStencil2D.build(nx=12, ny=12, dtype=jnp.float64)
    port = StencilPencil2D.build(nx=12, ny=12, dtype=torch.float64,
                                 device="cpu")
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (ref.n_padded,),
                                    dtype=jnp.float64))
    v0[ref.n:] = 0.0
    want = ref_si.shift_invert_lanczos(ref, sigma=45.0, nev=3, maxiter=30,
                                       tol=1e-7, backend="iterative")
    got = shift_invert.shift_invert_lanczos(port, sigma=45.0, nev=3,
                                            maxiter=30, tol=1e-7,
                                            backend="iterative", v0=v0)
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-7)
    cav = RectCavity2D(nx=12, ny=12)
    import scipy.linalg

    w = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(), eigvals_only=True)
    np.testing.assert_allclose(np.sort(got.eigenvalues),
                               _nearest(w[w > 1e-8], 45.0, 3), rtol=1e-7)


def test_solve_shift_invert(setup):
    """solve(solver="shift_invert"): sigma required, maxiter 60 by
    default."""
    _, _, prob, _, v0, golden = setup
    with pytest.raises(ValueError, match="sigma"):
        maxwell_tpu_torch.solve(prob, solver="shift_invert", device="cpu")
    got = maxwell_tpu_torch.solve(prob, nev=4, solver="shift_invert",
                                  sigma=45.0, device="cpu", v0=v0)
    assert got.converged and got.iterations == 60
    np.testing.assert_allclose(np.sort(got.eigenvalues),
                               _nearest(golden, 45.0, 4), rtol=1e-8)


def _last_json(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) in (0, None)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_config3_through_the_cli_matches_the_reference_cli():
    want = _last_json(ref_cli.main, [str(CONFIG3), "--platform", "cpu"])
    got = _last_json(port_cli.main, [str(CONFIG3), "--device", "cpu"])
    assert sorted(got) == sorted(want)  # no analytic row for shift-invert
    assert got["converged"] and max(got["residuals"]) <= 1e-8
    assert got["n"] == want["n"] and got["iterations"] == want["iterations"]
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=1e-8)
