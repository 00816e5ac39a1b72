"""solvers/rr.small_eigh, the port's one small dense eigh: it runs in f64
on the input's device whatever the working dtype and hands back the input's
dtype, and every small eigh of the LOBPCG path (SVQB, eigh_gen /
rayleigh_ritz, LOBPCG's own Rayleigh-Ritz step, lobpcg_dist) goes through
it, so no f32 torch.linalg.eigh runs anywhere on that path."""

import importlib

import numpy as np
import pytest
import torch

from maxwell_tpu_torch.dist import partition_problem
from maxwell_tpu_torch.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu_torch.solvers import rr
from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist
from maxwell_tpu_torch.solvers.operator import Pencil

torch.set_num_threads(1)

# the module (maxwell_tpu_torch.solvers exports a function of that name)
lob = importlib.import_module("maxwell_tpu_torch.solvers.lobpcg")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [7, 21])
def test_small_eigh_matches_numpy_f64(dtype, n):
    """theta ascending and V in the input's dtype; against numpy's f64 eigh
    of the symmetrised matrix: eigenvalues to n eps of the dtype times
    max|theta|, the eigen-residual of the rounded V to n eps of ||A||
    (the backward-stable bound of a dense eigh)."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    A = A + A.T + 1e-3 * rng.standard_normal((n, n))  # not quite symmetric
    At = torch.from_numpy(A).to(dtype)
    theta, V = rr.small_eigh(At)
    assert theta.dtype == V.dtype == dtype
    assert theta.shape == (n,) and V.shape == (n, n)
    S = 0.5 * (At.double() + At.double().T).numpy()
    w = np.linalg.eigvalsh(S)
    eps = torch.finfo(dtype).eps
    th = theta.double().numpy()
    assert np.all(np.diff(th) >= 0)
    assert np.abs(th - w).max() <= n * eps * np.abs(w).max()
    Vd = V.double().numpy()
    resid = np.linalg.norm(S @ Vd - Vd * th[None, :]) / np.linalg.norm(S)
    assert resid <= n * eps


def test_small_eigh_f32_is_the_rounded_f64_result():
    """For an f32 input the result is the f64 decomposition rounded to f32
    (no f32 eigh in between)."""
    A = torch.from_numpy(np.random.default_rng(3).standard_normal((9, 9)))
    A = (A + A.T).float()
    theta, V = rr.small_eigh(A)
    t64, V64 = torch.linalg.eigh(A.double())
    assert torch.equal(theta, t64.float()) and torch.equal(V, V64.float())


@pytest.fixture
def eigh_dtypes(monkeypatch):
    """The dtype of every torch.linalg.eigh call, and the number of
    small_eigh calls."""
    seen, calls = [], []
    eigh = torch.linalg.eigh

    def recording(A, *args, **kwargs):
        seen.append(A.dtype)
        return eigh(A, *args, **kwargs)

    small = rr.small_eigh

    def counting(A):
        calls.append(A.dtype)
        return small(A)

    monkeypatch.setattr(torch.linalg, "eigh", recording)
    monkeypatch.setattr(rr, "small_eigh", counting)
    monkeypatch.setattr(lob, "small_eigh", counting)
    return seen, calls


def test_every_lobpcg_eigh_goes_through_small_eigh(eigh_dtypes):
    """An f32 LOBPCG with the preconditioner, the stand-alone
    rayleigh_ritz/eigh_gen and an f32 lobpcg_dist: each small eigh is a
    small_eigh call, and torch.linalg.eigh only ever sees f64."""
    seen, calls = eigh_dtypes
    pen = Pencil.from_problem(BrickCavity3D(nx=4, ny=4, nz=4), kernel="ref",
                              dtype=torch.float32, device="cpu")
    X0 = np.random.default_rng(1).standard_normal((pen.n, 7))
    lob.lobpcg(pen, nev=3, maxiter=8, tol=1e-5, X0=X0)
    n_lobpcg = len(calls)
    assert n_lobpcg >= 3  # the first SVQB, then SVQB and Rayleigh-Ritz
    S = torch.zeros((pen.n_padded, 7))
    S[:pen.n] = torch.from_numpy(X0).float()
    KS, MS = pen.KM_mm(S)
    rr.rayleigh_ritz(S, KS, MS, nev=3)
    assert len(calls) == n_lobpcg + 1
    dp = partition_problem(RectCavity2D(nx=8, ny=8), 4, kernel="ref",
                           dtype=torch.float32, device="cpu")
    lobpcg_dist(dp, nev=2, maxiter=4, tol=1e-5,
                X0=np.random.default_rng(2).standard_normal((dp.n, 6)))
    assert len(calls) > n_lobpcg + 1
    assert set(calls) == {torch.float32}
    assert seen and set(seen) == {torch.float64}
