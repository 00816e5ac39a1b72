"""The port's native host code (maxwell_tpu_torch/native) against the JAX
package's (maxwell_tpu/native): the same source, byte for byte; the LDL^T
factor (Lp, Li, Lx, D), the level schedules and the blocked-ELL fill equal
bit for bit on config 3's 16x16 rectangle; a zero pivot raises
ZeroDivisionError; a broken build raises with the compiler's output."""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from maxwell_tpu import native as ref_native
from maxwell_tpu.problems import RectCavity2D
from maxwell_tpu_torch import native

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cav():
    return RectCavity2D(nx=16, ny=16)


def _shifted(cav, sigma):
    A = (cav.K - sigma * cav.M).tocsr()
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    return sp.triu(A[perm][:, perm].tocsc()).tocsc()


def test_native_cpp_is_a_byte_copy():
    assert (ROOT / "maxwell_tpu_torch/native/native.cpp").read_bytes() == (
        ROOT / "maxwell_tpu/native/native.cpp").read_bytes()


def test_library_lands_in_the_build_directory():
    lib = native.build()
    assert lib.parent == ROOT / "build" / "maxwell_tpu_torch"
    assert lib.exists() and lib.name.startswith("libmaxwell_native_")


@pytest.mark.parametrize("sigma", [45.0, 1.0])
def test_ldlt_factor_bitwise_equal(cav, sigma):
    assert ref_native.HAVE_NATIVE
    Au = _shifted(cav, sigma)
    got = native.ldlt_factor(Au)
    want = ref_native.ldlt_factor(Au)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # L D L^T reconstructs the (permuted) shifted matrix
    Lp, Li, Lx, D = got
    n = Au.shape[0]
    L = sp.csc_matrix((Lx, Li, Lp), shape=(n, n)) + sp.eye(n)
    A = Au + sp.triu(Au, 1).T
    assert abs(L @ sp.diags(D) @ L.T - A).max() < 1e-9


@pytest.mark.parametrize("sigma", [45.0, 1.0])
@pytest.mark.parametrize("lower", [True, False])
def test_level_schedule_levels_bitwise_equal(cav, sigma, lower):
    Lp, Li, Lx, _ = native.ldlt_factor(_shifted(cav, sigma))
    n = len(Lp) - 1
    L = sp.csc_matrix((Lx, Li, Lp), shape=(n, n)) + sp.eye(n)
    T = (L if lower else L.T).tocsr()
    lev, nl = native.level_schedule_levels(T.indptr, T.indices, n, lower)
    want_lev, want_nl = ref_native.level_schedule_levels(
        T.indptr, T.indices, n, lower)
    assert nl == want_nl and np.array_equal(lev, want_lev)
    assert nl == lev.max() + 1


def test_zero_pivot_raises():
    A = sp.triu(sp.csc_matrix(np.array([[0.0, 1.0], [1.0, 0.0]]))).tocsc()
    with pytest.raises(ZeroDivisionError, match="zero pivot"):
        native.ldlt_factor(A)
    with pytest.raises(ZeroDivisionError):
        ref_native.ldlt_factor(A)


def test_bell_from_csr_matches_reference(cav):
    K = cav.K.tocsr()
    n = (K.shape[0] + 7) // 8 * 8
    Kp = sp.csr_matrix((K.data, K.indices, np.concatenate(
        [K.indptr, np.full(n - K.shape[0], K.indptr[-1])])),
        shape=(n, n))
    got = native.bell_from_csr(Kp.indptr, Kp.indices, Kp.data, n, 8, 16)
    want = ref_native.bell_from_csr(Kp.indptr, Kp.indices, Kp.data, n, 8, 16)
    assert got[2] == want[2]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_broken_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not any((tmp_path / "build").glob("*.so"))
