"""Level-scheduled triangular solves of maxwell_tpu_torch
(kernels/tri_solve.py) against the JAX package's (maxwell_tpu/kernels/
tri_solve.py) on the CPU, where the wrapper runs its plain version: the
LevelSchedule arrays of splu's L/U and the LDL^T L/L^T of config 3's 16x16
rectangle at sigma 45 equal the reference's; the per-factor and factored
solves match the reference's solves (f64 to 1e-12 relative to max|x|; f32
to 1e-5, or to 4 times the reference's own f32 error where that is
larger) and scipy (f64 to 1e-12) at m 1 and 4."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from maxwell_tpu.kernels import tri_solve as ref_tri
from maxwell_tpu.problems import RectCavity2D
from maxwell_tpu_torch.kernels import tri_solve

torch.set_num_threads(1)

SIGMA = 45.0
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NP = {torch.float64: np.float64, torch.float32: np.float32}


@pytest.fixture(scope="module")
def shifted():
    cav = RectCavity2D(nx=16, ny=16)
    return (cav.K - SIGMA * cav.M).tocsr()


@pytest.fixture(scope="module")
def factors(shifted):
    """{name: (port LevelSchedule, reference LevelSchedule, host CSR)} of
    splu's L and U and the LDL^T's L and L^T, at f64 on the CPU."""
    lu = spla.splu(shifted.tocsc())
    p_lu = tri_solve.SparseLUDevice.from_splu(lu, device="cpu")
    r_lu = ref_tri.SparseLUDevice.from_splu(lu)
    p_ld = tri_solve.SparseLDLTDevice.factor(shifted, device="cpu")
    r_ld = ref_tri.SparseLDLTDevice.factor(shifted)
    return {
        "splu_L": (p_lu.L, r_lu.L, lu.L.tocsr()),
        "splu_U": (p_lu.U, r_lu.U, lu.U.tocsr()),
        "ldlt_L": (p_ld.L, r_ld.L, None),
        "ldlt_Lt": (p_ld.Lt, r_ld.Lt, None),
    }


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(
        np.asarray(want)).max()


def _ref_cast(obj, dtype):
    """The reference's solver object with its values in dtype (its own
    from_csr keeps the CSR's f64): every float leaf cast."""
    def cast(v):
        if isinstance(v, ref_tri.LevelSchedule):
            return _ref_cast(v, dtype)
        if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating):
            return jnp.asarray(v, dtype=dtype)
        return v

    return dataclasses.replace(obj, **{f.name: cast(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})


@pytest.mark.parametrize("name", ["splu_L", "splu_U", "ldlt_L", "ldlt_Lt"])
def test_level_schedule_arrays_equal_the_reference(factors, name):
    port, ref, _ = factors[name]
    assert port.n == ref.n and port.lower == ref.lower
    for f in ("rows", "cols", "vals", "diag"):
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.shape == want.shape and np.array_equal(got, want), f
    # the port's live counts agree with the padding they skip
    n = port.n
    assert np.array_equal(port.live.numpy(), (port.rows < n).sum(1).numpy())
    assert np.array_equal(port.cnt.numpy(), (port.cols < n).sum(2).numpy())
    assert port.dinv[-1] == 1.0


def test_ldlt_factor_is_a_chain(factors):
    """After RCM the LDL^T factor is a chain: one row a level, (480, 1,
    31) at 16x16."""
    L = factors["ldlt_L"][0]
    assert tuple(L.cols.shape) == (480, 1, 31)
    assert L.live.max() == 1


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("name", ["splu_L", "splu_U", "ldlt_L", "ldlt_Lt"])
def test_level_solve_plain_matches_reference(factors, name, m):
    port, ref, csr = factors[name]
    rng = np.random.default_rng(m)
    B = rng.standard_normal((port.n, m))
    tri_solve.reset_counts()
    got = tri_solve.level_solve(port, torch.from_numpy(B))
    assert tri_solve.counts() == {"level_solve": 0, "level_solve_plain": 1}
    assert _rel(got, ref.solve(jnp.asarray(B))) <= TOL[torch.float64]
    if csr is not None:
        want = spla.spsolve_triangular(csr, B, lower=port.lower)
        assert _rel(got, want) <= TOL[torch.float64]
    x = tri_solve.level_solve(port, torch.from_numpy(B[:, 0]))
    assert x.shape == (port.n,)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["splu", "ldlt"])
def test_factored_solve_matches_reference_and_scipy(shifted, kind, dtype, m):
    rng = np.random.default_rng(10 + m)
    B = rng.standard_normal((shifted.shape[0], m))
    if kind == "splu":
        lu = spla.splu(shifted.tocsc())
        port = tri_solve.SparseLUDevice.from_splu(lu, dtype=dtype,
                                                  device="cpu")
        ref = ref_tri.SparseLUDevice.from_splu(lu)
    else:
        port = tri_solve.SparseLDLTDevice.factor(shifted, dtype=dtype,
                                                 device="cpu")
        ref = ref_tri.SparseLDLTDevice.factor(shifted)
    got = port.solve(torch.from_numpy(B).to(dtype))
    assert got.dtype == dtype and got.shape == B.shape
    want = ref.solve(jnp.asarray(B))
    tol = TOL[dtype]
    if dtype == torch.float32:
        # the reference's own f32 solve is off its f64 solve by 2e-6 (splu)
        # to 2e-5 (LDL^T, no pivoting: the rounding grows along the chain of
        # 480 levels); two f32 solves that sum in other orders differ by as
        # much, so the bound is 1e-5 or 4 times the reference's own f32
        # error, whichever is larger
        want32 = _ref_cast(ref, np.float32).solve(
            jnp.asarray(B, dtype=np.float32))
        tol = max(tol, 4 * _rel(want32, want))
        want = want32
    assert _rel(got, want) <= tol
    if dtype == torch.float64:
        want = spla.spsolve(shifted.tocsc(), B).reshape(B.shape)
        assert _rel(got, want) <= TOL[dtype]
    if m == 1:
        assert port.solve(torch.from_numpy(B[:, 0]).to(dtype)).shape == (
            shifted.shape[0],)


@pytest.mark.parametrize("lower", [True, False])
def test_random_triangular_matches_scipy(lower):
    """The reference's own random-factor checks (tests/unit/
    test_tri_solve.py) through the port's schedule."""
    rng = np.random.default_rng(3 if lower else 4)
    n = 80 if lower else 60
    T = sp.random(n, n, density=0.05, random_state=3 if lower else 4).tolil()
    T[np.arange(n), np.arange(n)] = 1.0 if lower else 2.0 + rng.random(n)
    T = (sp.tril if lower else sp.triu)(T.tocsr()).tocsr()
    S = tri_solve.LevelSchedule.from_csr(T, lower=lower, device="cpu")
    B = rng.standard_normal((n, 3))
    got = tri_solve.level_solve(S, torch.from_numpy(B))
    want = spla.spsolve_triangular(T, B, lower=lower)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    ref = ref_tri.LevelSchedule.from_csr(T, lower=lower)
    assert S.n_levels == ref.n_levels


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["splu_L", "splu_U", "ldlt_L", "ldlt_Lt"])
def test_backward_error_separates_solves_from_perturbed_ones(factors, name,
                                                             dtype):
    """backward_error, the card's gate for the kernel, is under its bound
    of 2 for the plain version's solves and far above it for a solution
    off by 1e-4 relative."""
    port, _, _ = factors[name]
    S = dataclasses.replace(port, vals=port.vals.to(dtype),
                            diag=port.diag.to(dtype),
                            dinv=port.dinv.to(dtype))
    B = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (S.n, 4))).to(dtype)
    X = tri_solve.level_solve(S, B)
    assert tri_solve.backward_error(S, B, X) <= 2
    assert tri_solve.backward_error(S, B, X * (1 + 1e-4)) > 2
