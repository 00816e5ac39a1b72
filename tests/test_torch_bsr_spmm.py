"""Blocked-ELL SpMM of maxwell_tpu_torch: the plain PyTorch versions against
the JAX package's Pallas kernels in interpret mode, on JAX layouts carried
across; the "pallas" pencil's applies; the wrappers' checks. The CUDA
kernels themselves are tested in test_torch_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.kernels import spmm as ref_spmm
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.solvers.operator import Pencil as RefPencil
from maxwell_tpu.sparse.bsr import BSRMatrix as RefBSR
from maxwell_tpu.sparse.bsr import bsr_matmat_ref as jax_bsr_matmat_ref
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.kernels import bsr_spmm
from maxwell_tpu_torch.problems import RectCavity2D
from maxwell_tpu_torch.solvers.operator import Pencil
from maxwell_tpu_torch.sparse.bsr import BSRMatrix

torch.set_num_threads(1)

# f32 summation order differs from the reference's: its own SpMM tests use
# 1e-5, and 1e-4 for the windowed kernel on the 3D RCM operator
# (tests/unit/test_pallas_spmm.py:27-29, :68-70)
TOL = {"rect2d_16x16": 1e-5, "brick_6x6x6_rcm": 1e-5}
WINDOWED_TOL = {"rect2d_16x16": 1e-5, "brick_6x6x6_rcm": 1e-4}


# interpret mode unrolls R x S slices per tile: ~13 s per width on the
# brick (S = 32), so the brick runs at one width
CASES = [("rect2d_16x16", 1), ("rect2d_16x16", 8), ("rect2d_16x16", 16),
         ("brick_6x6x6_rcm", 8)]


@pytest.fixture(scope="module")
def all_layouts():
    out = {}
    for case in TOL:
        if case == "rect2d_16x16":
            prob = RefRect(nx=16, ny=16)
        else:
            prob = RefPermuted(RefBrick(nx=6, ny=6, nz=6))
        ref = RefBSR.from_csr(prob.K, block=8, dtype=jnp.float32)
        out[case] = (ref, BSRMatrix.from_reference(ref, device="cpu"))
    return out


def _x(rows, m, seed):
    return np.random.default_rng(seed).standard_normal((rows, m)).astype(
        np.float32
    )


@pytest.mark.parametrize("case,m", CASES)
def test_plain_matmat_matches_pallas_interpret(all_layouts, case, m):
    ref, port = all_layouts[case]
    X = _x(port.n_padded, m, seed=m)
    want = np.asarray(
        ref_spmm.bsr_matmat_pallas(ref, jnp.asarray(X), interpret=True)
    )
    got = bsr_spmm.bsr_matmat(port, torch.from_numpy(X)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL[case], atol=TOL[case])


@pytest.mark.parametrize("case,m", CASES)
def test_plain_windowed_matches_pallas_interpret(all_layouts, case, m):
    ref, port = all_layouts[case]
    assert port.win_unit > 0
    X = _x(port.n_padded, m, seed=10 + m)
    want = np.asarray(
        ref_spmm.bsr_matmat_pallas_windowed(ref, jnp.asarray(X),
                                            interpret=True)
    )
    got = bsr_spmm.bsr_matmat_windowed(port, torch.from_numpy(X)).numpy()
    assert got.shape == want.shape
    tol = WINDOWED_TOL[case]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(TOL))
def test_plain_matvec_matches_pallas_interpret(all_layouts, case):
    """bsr_matvec_pallas widens x to an 8-lane panel and has no interpret
    switch: its body, run on that panel, is the reference here."""
    ref, port = all_layouts[case]
    x = _x(port.n_padded, 1, seed=21)[:, 0]
    X8 = np.zeros((port.n_padded, 8), np.float32)
    X8[:, 0] = x
    want = np.asarray(
        ref_spmm.bsr_matmat_pallas(ref, jnp.asarray(X8), interpret=True)
    )[:, 0]
    got = bsr_spmm.bsr_matvec(port, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL[case], atol=TOL[case])


@pytest.mark.parametrize("case", sorted(TOL))
def test_plain_windowed_reads_the_window(all_layouts, case):
    """The windowed plain version gathers through win_start/cols_rel: a
    window start moved by one unit moves every nonzero slot's source."""
    _, port = all_layouts[case]
    X = torch.from_numpy(_x(port.n_padded, 3, seed=4))
    shifted = dataclasses.replace(port, win_start=port.win_start + 1)
    Y = bsr_spmm.bsr_matmat_windowed(port, X)
    assert not torch.allclose(bsr_spmm.bsr_matmat_windowed(shifted, X), Y)
    torch.testing.assert_close(Y, bsr_spmm.bsr_matmat(port, X))


@pytest.fixture(scope="module")
def pencils():
    kw = dict(nx=16, ny=16)
    ref = RefPencil.from_problem(RefRect(**kw), kernel="pallas",
                                 dtype=jnp.float32)
    port = Pencil.from_problem(RectCavity2D(**kw), kernel="pallas",
                               dtype=torch.float32, device="cpu")
    return ref, port


@pytest.mark.parametrize("shape", ["block", "column", "vector"])
def test_pallas_pencil_applies_match_reference(pencils, shape):
    """K_mm, M_mm and KM_mm of the port's "pallas" pencil (plain versions on
    the CPU) against the JAX pencil's layouts through its jnp product (its
    own K_mm would call the TPU kernel without interpret)."""
    ref, port = pencils
    assert (port.K.b, port.K.slots, port.n_padded) == (
        ref.K.b, ref.K.slots, ref.n_padded
    )
    m = {"block": 8, "column": 1, "vector": 1}[shape]
    X = _x(port.n_padded, m, seed=30)
    X[port.n:] = 0
    want = [np.asarray(jax_bsr_matmat_ref(A, jnp.asarray(X)))
            for A in (ref.K, ref.M)]
    Xt = torch.from_numpy(X[:, 0] if shape == "vector" else X)
    bsr_spmm.reset_counts()
    got = [port.K_mm(Xt), port.M_mm(Xt), *port.KM_mm(Xt)]
    for g, w in zip(got, want + want):
        g = g.numpy()
        assert g.shape == (w[:, 0] if shape == "vector" else w).shape
        g = g.reshape(w.shape)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    # a vector and a one-column block go to the SpMV, wider blocks to the
    # SpMM
    c = bsr_spmm.counts()
    want_calls = ("bsr_matmat_ref", 4) if m > 1 else ("bsr_matvec_ref", 4)
    assert c[want_calls[0]] == want_calls[1]
    assert sum(c.values()) == 4


def test_pallas_pencil_from_reference(pencils):
    ref, port = pencils
    got = Pencil.from_reference(ref, device="cpu")
    assert got.kernel == "pallas" and got.K.win_unit == ref.K.win_unit
    X = torch.from_numpy(_x(port.n_padded, 5, seed=31))
    for g, w in zip(got.KM_mm(X), port.KM_mm(X)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.project(X), port.project(X), rtol=1e-5,
                               atol=1e-5)


def test_pencil_kernels_accepted_and_refused():
    prob = RectCavity2D(nx=4, ny=4)
    p = Pencil.from_problem(prob, kernel="pallas", device="cpu")
    assert p.K.b == 8 and p.K.slots % 16 == 0 and p.M is not None
    bp = Pencil.from_problem(prob, kernel="bellpairs", device="cpu")
    assert bp.M is None and bp.K.vals2d_b is not None and bp.K.b == 8
    with pytest.raises(ValueError):
        Pencil.from_problem(prob, kernel="nope", device="cpu")


def test_counters_split_kernel_and_plain(all_layouts):
    _, port = all_layouts["rect2d_16x16"]
    bsr_spmm.reset_counts()
    X = torch.from_numpy(_x(port.n_padded, 2, seed=1))
    bsr_spmm.bsr_matmat(port, X)
    bsr_spmm.bsr_matmat_windowed(port, X)
    bsr_spmm.bsr_matvec(port, X[:, 0].contiguous())
    c = bsr_spmm.counts()
    assert c == {"bsr_matmat": 0, "bsr_matmat_windowed": 0, "bsr_matvec": 0,
                 "bsr_matmat_ref": 1, "bsr_matmat_windowed_ref": 1,
                 "bsr_matvec_ref": 1}


@pytest.mark.parametrize(
    "bad", ["f64", "non_contiguous", "misaligned", "block4", "no_window",
            "short_x"]
)
def test_wrappers_reject_bad_device_input(bad):
    """A tensor that is not on the CPU takes the kernel path, which checks
    its input before any build or launch (meta tensors stand in for CUDA
    ones here). No check falls back to the plain version."""
    prob = RefPermuted(RefBrick(nx=6, ny=6, nz=6))
    kw = {}
    if bad == "misaligned":
        kw = dict(row_align=1)
    elif bad == "block4":
        kw = dict(block=4)
    A = BSRMatrix.from_csr(prob.K, device="cpu", **kw)
    if bad == "misaligned":
        assert A.n_brows % 16
    rows, dtype = A.n_padded, torch.float32
    if bad == "f64":
        dtype = torch.float64
    if bad == "short_x":
        rows -= 8
    X = torch.empty((rows, 4), dtype=dtype, device="meta")
    if bad == "non_contiguous":
        X = torch.empty((4, rows), device="meta").T
    if bad == "no_window":
        A = dataclasses.replace(A, win_start=None, cols_rel=None, win_unit=0)
        with pytest.raises(ValueError, match="window"):
            bsr_spmm.bsr_matmat_windowed(A, X)
        with pytest.raises(ValueError, match="window"):
            bsr_spmm.bsr_matmat_windowed(A, torch.zeros(X.shape))
        return
    with pytest.raises(ValueError):
        bsr_spmm.bsr_matmat(A, X)
    with pytest.raises(ValueError):
        bsr_spmm.bsr_matmat_windowed(A, X)
    if bad != "non_contiguous":
        with pytest.raises(ValueError):
            bsr_spmm.bsr_matvec(A, X[:, 0])
