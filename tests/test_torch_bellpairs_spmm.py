"""BELLPairs SpMM of maxwell_tpu_torch: the plain PyTorch versions against
the JAX package's Pallas kernels in interpret mode, on JAX layouts carried
across; the "bellpairs" pencil's applies against the JAX bellpairs pencil;
the wrappers' checks. The CUDA kernels themselves are tested in
test_torch_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from jax.experimental.pallas import tpu as pltpu

from maxwell_tpu.kernels import spmm as ref_spmm
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.solvers.operator import Pencil as RefPencil
from maxwell_tpu.sparse.bellpairs import BELLPairs as RefPairs
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.kernels import bellpairs_spmm as kp
from maxwell_tpu_torch.problems import BrickCavity3D
from maxwell_tpu_torch.solvers.operator import Pencil
from maxwell_tpu_torch.sparse.bellpairs import BandedBELLPairs, BELLPairs

torch.set_num_threads(1)

# f32 summation order differs from the reference's: its own BELLPairs tests
# hold the kernels to 1e-5 of max|ref| (tests/unit/test_pallas_spmm.py:97,
# 119, 148-157)
TOL = 1e-5


def _layout(grid, with_b=True):
    cav = RefPermuted(RefBrick(nx=grid[0], ny=grid[1], nz=grid[2]))
    ref = RefPairs.from_csr(cav.K, block=8, Cp=8, dtype=jnp.float32,
                            B=cav.M if with_b else None)
    return ref, BELLPairs.from_reference(ref, device="cpu")


@pytest.fixture(scope="module")
def layouts():
    return {"6x6x6": _layout((6, 6, 6)), "8x8x8": _layout((8, 8, 8))}


def _x(rows, m, seed):
    return np.random.default_rng(seed).standard_normal((rows, m)).astype(
        np.float32
    )


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("stream", ["a", "b"])
def test_plain_matmat_matches_pallas_interpret(layouts, stream, m):
    ref, port = layouts["6x6x6"]
    X = _x(port.n_padded, m, seed=m)
    want = ref_spmm.bellpairs_matmat_pallas(ref, jnp.asarray(X),
                                            interpret=True, stream=stream)
    _close(kp.bellpairs_matmat(port, torch.from_numpy(X), stream).numpy(),
           want)


@pytest.mark.parametrize("m", [1, 8])
def test_plain_km_matmat_matches_pallas_interpret(layouts, m):
    ref, port = layouts["6x6x6"]
    X = _x(port.n_padded, m, seed=20 + m)
    want = ref_spmm.bellpairs_km_matmat_pallas(ref, jnp.asarray(X),
                                               interpret=True)
    got = kp.bellpairs_km_matmat(port, torch.from_numpy(X))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("m", [1, 8])
def test_plain_windowed_matches_pallas_interpret(layouts, m):
    ref, port = layouts["8x8x8"]
    assert port.win_unit > 0
    X = _x(port.n_padded, m, seed=30 + m)
    want = ref_spmm.bellpairs_matmat_pallas_windowed(ref, jnp.asarray(X),
                                                     interpret=True)
    _close(kp.bellpairs_matmat_windowed(port, torch.from_numpy(X)).numpy(),
           want)


def test_plain_windowed_reads_the_window(layouts):
    """The windowed plain version gathers through win_start/cols_rel: a
    window start moved by one unit moves every live slot's source."""
    _, port = layouts["8x8x8"]
    X = torch.from_numpy(_x(port.n_padded, 3, seed=4))
    shifted = dataclasses.replace(port, win_start=port.win_start + 1)
    Y = kp.bellpairs_matmat_windowed(port, X)
    assert not torch.allclose(kp.bellpairs_matmat_windowed(shifted, X), Y)
    torch.testing.assert_close(Y, kp.bellpairs_matmat(port, X))


def _empty_tile_layout():
    Ac = sp.eye(100).tocoo()
    Af = sp.coo_matrix((Ac.data, (Ac.row, Ac.col)), shape=(256, 256)).tocsr()
    ref = RefPairs.from_csr(Af, block=8, dtype=jnp.float32, B=2.0 * Af)
    return ref.banded(m=8, budget_bytes=130 * 4 * 8)


@pytest.mark.parametrize("fn", ["matmat", "km_matmat"])
@pytest.mark.parametrize("case", ["6x6x6", "empty_tile"])
def test_plain_banded_matches_pallas_interpret(layouts, case, fn):
    if case == "6x6x6":
        AB = layouts["6x6x6"][0].banded(m=8, budget_bytes=12 * 1024)
    else:
        AB = _empty_tile_layout()
    assert len(AB.bands) >= 2
    port = BandedBELLPairs.from_reference(AB, device="cpu")
    X = _x(port.n_padded, 8, seed=3)
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    if fn == "matmat":
        want = (ref_spmm.bellpairs_matmat_banded(AB, Xj, interpret=True),)
        got = (kp.bellpairs_matmat_banded(port, Xt),)
    else:
        want = ref_spmm.bellpairs_km_matmat_banded(AB, Xj, interpret=True)
        got = kp.bellpairs_km_matmat_banded(port, Xt)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_banded_equals_full_product(layouts):
    """The port's own band split gives the full product (stream b too)."""
    _, port = layouts["6x6x6"]
    AB = port.banded(m=8, budget_bytes=12 * 1024)
    X = torch.from_numpy(_x(port.n_padded, 5, seed=6))
    for s in "ab":
        torch.testing.assert_close(kp.bellpairs_matmat_banded(AB, X, s),
                                   kp.bellpairs_matmat(port, X, s))


@pytest.fixture(scope="module")
def pencils():
    kw = dict(nx=5, ny=5, nz=5)
    ref = RefPencil.from_problem(RefBrick(**kw), kernel="bellpairs",
                                 dtype=jnp.float32)
    port = Pencil.from_problem(BrickCavity3D(**kw), kernel="bellpairs",
                               dtype=torch.float32, device="cpu")
    return ref, port


@pytest.mark.parametrize("shape", ["block", "column", "vector"])
def test_bellpairs_pencil_applies_match_reference(pencils, shape):
    """K_mm, M_mm and KM_mm of the port's "bellpairs" pencil (plain versions
    on the CPU) against the JAX bellpairs pencil's Pallas kernels in
    interpret mode (tests/unit/test_pallas_spmm.py:160-181)."""
    ref, port = pencils
    assert port.M is None and port.K.vals2d_b is not None
    assert port.n_padded == ref.n_padded
    m = {"block": 8, "column": 1, "vector": 1}[shape]
    X = _x(port.n_padded, m, seed=40)
    X[port.n:] = 0
    if shape == "vector":
        X = X[:, 0]
    with pltpu.force_tpu_interpret_mode():
        Xj = jnp.asarray(X)
        want = [ref.K_mm(Xj), ref.M_mm(Xj), *ref.KM_mm(Xj)]
    kp.reset_counts()
    Xt = torch.from_numpy(X)
    got = [port.K_mm(Xt), port.M_mm(Xt), *port.KM_mm(Xt)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
    # one-stream applies for K_mm and M_mm (a vector as an m = 1 product),
    # the fused apply for KM_mm
    c = kp.counts()
    assert c["bellpairs_matmat_ref"] == 2 and c["bellpairs_km_matmat_ref"] == 1
    assert sum(c.values()) == 3


def test_bellpairs_pencil_minv_is_mass_solve(pencils):
    """M is None on a bellpairs pencil (it is K's second stream): Minv_mm
    solves with the mass matrix, not the identity shortcut."""
    _, port = pencils
    prob = BrickCavity3D(nx=5, ny=5, nz=5)
    X = np.zeros((port.n_padded, 3))
    X[: port.n] = np.random.default_rng(0).standard_normal((port.n, 3))
    Y = port.Minv_mm(torch.from_numpy(X.astype(np.float32))).numpy()
    want = spla.spsolve(prob.M.tocsc(), X[: port.n])
    np.testing.assert_allclose(Y[: port.n], want, rtol=5e-4, atol=5e-4)


def test_bellpairs_pencil_from_reference(pencils):
    ref, port = pencils
    got = Pencil.from_reference(ref, device="cpu")
    assert got.kernel == "bellpairs" and got.M is None
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert torch.equal(got.K.vals2d, port.K.vals2d)
    assert torch.equal(got.K.vals2d_b, port.K.vals2d_b)
    X = torch.from_numpy(_x(port.n_padded, 5, seed=41))
    for g, w in zip(got.KM_mm(X), port.KM_mm(X)):
        torch.testing.assert_close(g, w)
    torch.testing.assert_close(got.project(X), port.project(X), rtol=1e-5,
                               atol=1e-5)


def test_counters_split_kernel_and_plain(layouts):
    _, port = layouts["8x8x8"]
    AB = port.banded(m=8, budget_bytes=64 * 1024)
    X = torch.from_numpy(_x(port.n_padded, 2, seed=1))
    kp.reset_counts()
    kp.bellpairs_matmat(port, X, "b")
    kp.bellpairs_km_matmat(port, X)
    kp.bellpairs_matmat_windowed(port, X)
    kp.bellpairs_matmat_banded(AB, X)
    kp.bellpairs_km_matmat_banded(AB, X)
    assert kp.counts() == {
        "bellpairs_matmat": 0, "bellpairs_km_matmat": 0,
        "bellpairs_matmat_windowed": 0, "bellpairs_matmat_banded": 0,
        "bellpairs_km_matmat_banded": 0,
        "bellpairs_matmat_ref": 1, "bellpairs_km_matmat_ref": 1,
        "bellpairs_matmat_windowed_ref": 1, "bellpairs_matmat_banded_ref": 1,
        "bellpairs_km_matmat_banded_ref": 1,
    }


@pytest.mark.parametrize(
    "bad,match",
    [("f64", "f32"), ("non_contiguous", "contiguous"), ("block4", "8x8"),
     ("short_x", "rows"), ("no_stream_b", "stream 'b'"),
     ("no_window", "window")],
)
def test_wrappers_reject_bad_device_input(bad, match):
    """A tensor that is not on the CPU takes the kernel path, which checks
    its input before any build or launch (meta tensors stand in for CUDA
    ones here). No check falls back to the plain version."""
    cav = RefPermuted(RefBrick(nx=6, ny=6, nz=6))
    A = BELLPairs.from_csr(cav.K, block=4 if bad == "block4" else 8,
                           B=None if bad == "no_stream_b" else cav.M,
                           device="cpu")
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
        calls = [lambda X: kp.bellpairs_matmat_windowed(A, X)]
    elif bad == "no_stream_b":
        calls = [lambda X: kp.bellpairs_matmat(A, X, "b"),
                 lambda X: kp.bellpairs_km_matmat(A, X)]
    else:
        calls = [lambda X: kp.bellpairs_matmat(A, X, "a"),
                 lambda X: kp.bellpairs_matmat(A, X, "b"),
                 lambda X: kp.bellpairs_km_matmat(A, X),
                 lambda X: kp.bellpairs_matmat_windowed(A, X)]
        if bad != "non_contiguous":  # the banded forms pad X into a copy
            AB = A.banded(m=4, budget_bytes=1 << 30)
            calls += [lambda X: kp.bellpairs_matmat_banded(AB, X),
                      lambda X: kp.bellpairs_km_matmat_banded(AB, X)]
    kp.reset_counts()
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call(X)
    assert not any(kp.counts().values())
