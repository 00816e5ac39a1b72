"""BELLPairs layout of maxwell_tpu_torch against maxwell_tpu's: the builder
(no native converter on either side) gives the same arrays bit for bit, the
same band split, and exactly the operator it was built from."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.sparse.bellpairs import BELLPairs as RefPairs
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.problems import BrickCavity3D
from maxwell_tpu_torch.sparse.bellpairs import BandedBELLPairs, BELLPairs
from maxwell_tpu_torch.sparse.reorder import PermutedProblem

torch.set_num_threads(1)

FIELDS = ("vals2d", "vals2d_b", "cols", "nch", "npairs", "win_start",
          "cols_rel")
# (grid, with B = M): K alone; K and M on one structure; window metadata
CASES = {"6x5x4": ((6, 5, 4), False), "6x6x6": ((6, 6, 6), True),
         "8x8x8": ((8, 8, 8), True)}


def _problems(grid):
    kw = dict(nx=grid[0], ny=grid[1], nz=grid[2])
    return RefPermuted(RefBrick(**kw)), PermutedProblem(BrickCavity3D(**kw))


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request):
    grid, with_b = CASES[request.param]
    ref_prob, prob = _problems(grid)
    ref = RefPairs.from_csr(ref_prob.K, block=8, Cp=8, dtype=jnp.float32,
                            B=ref_prob.M if with_b else None)
    port = BELLPairs.from_csr(prob.K, block=8, Cp=8, dtype=torch.float32,
                              B=prob.M if with_b else None, device="cpu")
    return request.param, prob, ref, port


def _assert_same_arrays(ref, port, fields=FIELDS):
    for f in fields:
        want, got = getattr(ref, f), getattr(port, f)
        if want is None:
            assert got is None, f
            continue
        want, got = np.asarray(want), got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f


def test_from_csr_matches_reference_bit_for_bit(built):
    case, _, ref, port = built
    _assert_same_arrays(ref, port)
    assert (port.win_unit, port.n, port.b, port.Cp) == (
        ref.win_unit, ref.n, ref.b, ref.Cp
    )
    assert (port.n_brows, port.n_padded, port.max_ch, port.n_tiles) == (
        ref.n_brows, ref.n_padded, ref.max_ch, ref.n_tiles
    )
    assert (port.vals2d_b is not None) == CASES[case][1]
    if case == "8x8x8":
        assert port.win_unit > 0 and port.win_start is not None


def test_to_csr_is_the_operator(built):
    case, prob, ref, port = built
    K32 = sp.csr_matrix(prob.K, dtype=np.float32)
    assert abs(port.to_csr() - K32).max() == 0.0
    if CASES[case][1]:
        M32 = sp.csr_matrix(prob.M, dtype=np.float32)
        assert abs(port.to_csr("b") - M32).max() == 0.0
    assert port.nnz_streamed <= port.nnz_dense
    assert (port.nnz_streamed, port.nnz_dense) == (
        ref.nnz_streamed, ref.nnz_dense
    )


def test_live_slots_read_inside_x():
    """Every live slot's 2b rows of X lie inside n_padded (the builder's
    last-column clamp): the CUDA kernels need no X padding."""
    A = BELLPairs.from_csr(sp.eye(128, format="csr"), device="cpu")
    cols, npairs = A.cols.numpy(), A.npairs.numpy()
    live = np.arange(A.slots)[None, :] < npairs[:, None]
    assert (cols[live] + 2 <= A.n_brows).all()
    # the last block column (15) holds a singleton on block row 15, stored
    # as the second half of the pair at column 14
    assert A.n_brows == 16 and cols[15, 0] == 14 and cols[14, 0] == 14
    assert np.array_equal(A.vals2d.numpy()[120:128, 8:16], np.eye(8))
    assert not A.vals2d.numpy()[120:128, :8].any()


def test_banded_matches_reference():
    """A budget small enough to force several bands on 6^3: the same band
    split and band arrays as the reference's; the bands' values are views
    of the full layout's."""
    ref_prob, prob = _problems((6, 6, 6))
    ref = RefPairs.from_csr(ref_prob.K, block=8, Cp=8, dtype=jnp.float32,
                            B=ref_prob.M)
    port = BELLPairs.from_csr(prob.K, B=prob.M, device="cpu")
    want = ref.banded(m=8, budget_bytes=12 * 1024)
    got = port.banded(m=8, budget_bytes=12 * 1024)
    assert len(got.bands) >= 2 and len(got.bands) == len(want.bands)
    assert got.col_starts == want.col_starts
    assert got.col_rows == want.col_rows
    assert (got.n, got.b, got.n_padded) == (want.n, want.b, want.n_padded)
    for w, g in zip(want.bands, got.bands):
        _assert_same_arrays(w, g, ("vals2d", "vals2d_b", "cols", "nch",
                                   "npairs"))
        assert (g.vals2d.untyped_storage().data_ptr()
                == port.vals2d.untyped_storage().data_ptr())
    assert got.n_padded == port.n_padded


def test_banded_empty_tile():
    """A tile with zero live slots gets a clamped (valid) window, as in
    tests/unit/test_pallas_spmm.py:328-351: the second 128-row tile of
    eye(100) in 256 x 256 lands in its own band."""
    Ac = sp.eye(100).tocoo()
    Af = sp.coo_matrix((Ac.data, (Ac.row, Ac.col)), shape=(256, 256)).tocsr()
    ref = RefPairs.from_csr(Af, block=8, dtype=jnp.float32)
    port = BELLPairs.from_csr(Af, device="cpu")
    want = ref.banded(m=8, budget_bytes=130 * 4 * 8)
    got = port.banded(m=8, budget_bytes=130 * 4 * 8)
    assert len(got.bands) >= 2 and all(r > 0 for r in got.col_rows)
    assert (got.col_starts, got.col_rows) == (want.col_starts, want.col_rows)
    for w, g in zip(want.bands, got.bands):
        _assert_same_arrays(w, g, ("vals2d", "cols", "nch", "npairs"))


def test_banded_refuses_a_tile_beyond_the_budget():
    _, prob = _problems((6, 6, 6))
    A = BELLPairs.from_csr(prob.K, device="cpu")
    with pytest.raises(ValueError, match="budget"):
        A.banded(m=8, budget_bytes=1024)


def test_from_reference_round_trip(built):
    _, _, ref, port = built
    got = BELLPairs.from_reference(ref, device="cpu")
    _assert_same_arrays(ref, got)
    assert got.win_unit == ref.win_unit and got.n == ref.n
    moved = got.to("cpu")
    _assert_same_arrays(ref, moved)


def test_banded_from_reference_round_trip():
    ref_prob, _ = _problems((6, 6, 6))
    ref = RefPairs.from_csr(ref_prob.K, block=8, Cp=8, dtype=jnp.float32,
                            B=ref_prob.M)
    want = ref.banded(m=8, budget_bytes=12 * 1024)
    got = BandedBELLPairs.from_reference(want, device="cpu")
    assert (got.col_starts, got.col_rows, got.n, got.b) == (
        want.col_starts, want.col_rows, want.n, want.b
    )
    for w, g in zip(want.bands, got.bands):
        _assert_same_arrays(w, g, ("vals2d", "vals2d_b", "cols", "nch",
                                   "npairs"))
    assert got.n_padded == want.n_padded
