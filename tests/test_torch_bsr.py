"""The blocked-ELL layout of maxwell_tpu_torch against the JAX package's:
CSR round trips, padding, slot counts and the per-tile window metadata.

The JAX builder fills each block row with its native converter, whose slot
order differs from the port's scipy path (the matrix is the same), so
layouts built apart are compared through to_csr, and the window metadata is
held to the JAX function on the same (blocks, cols) arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.sparse import bsr as ref_bsr
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.sparse import bsr
from maxwell_tpu_torch.sparse.bsr import BSRMatrix

torch.set_num_threads(1)

CASES = ["rect2d_16x16", "brick_6x6x6_rcm"]


def _problem(case):
    if case == "rect2d_16x16":
        return RefRect(nx=16, ny=16)
    return RefPermuted(RefBrick(nx=6, ny=6, nz=6))


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return request.param, _problem(request.param)


@pytest.mark.parametrize("align", [None, 4])
def test_from_csr_matches_reference(case, align):
    _, prob = case
    ref = ref_bsr.BSRMatrix.from_csr(prob.K, block=8, align_slots=align,
                                     dtype=jnp.float32)
    port = BSRMatrix.from_csr(prob.K, block=8, align_slots=align,
                              dtype=torch.float32, device="cpu")
    assert (port.n_padded, port.slots, port.win_unit) == (
        ref.n_padded, ref.slots, ref.win_unit
    )
    assert port.cols.dtype == torch.int32
    assert abs(port.to_csr() - ref.to_csr()).max() == 0
    assert abs(port.to_csr() - prob.K.astype(np.float32)).max() == 0


@pytest.mark.parametrize("which", ["reference_layout", "port_layout"])
def test_window_metadata_matches_reference(case, which):
    """The port's copy gives the JAX function's output exactly, on both
    builders' (blocks, cols)."""
    _, prob = case
    if which == "reference_layout":
        A = ref_bsr.BSRMatrix.from_csr(prob.K, block=8, dtype=jnp.float32)
        blocks, cols = np.asarray(A.blocks), np.asarray(A.cols)
    else:
        A = BSRMatrix.from_csr(prob.K, block=8, device="cpu")
        blocks, cols = A.blocks.numpy(), A.cols.numpy()
    want = ref_bsr._window_metadata(blocks, cols, 8)
    got = bsr._window_metadata(blocks, cols, 8)
    assert want[2] > 0 and got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_window_columns_rebuild_cols(case):
    """Every nonzero slot's window column, win_start * Wu + cols_rel, is its
    block column, and lies in the tile's two panels."""
    _, prob = case
    A = BSRMatrix.from_csr(prob.K, block=8, device="cpu")
    R = 128 // A.b
    nz = A.blocks.abs().amax(dim=(2, 3)) > 0
    start = A.win_start.long().repeat_interleave(R)[:, None] * A.win_unit
    rebuilt = start + A.cols_rel.long()
    assert torch.equal(rebuilt[nz], A.cols.long()[nz])
    assert int(A.cols_rel.min()) >= 0
    assert int(A.cols_rel.max()) < 2 * A.win_unit


def test_from_reference_round_trip(case):
    """A JAX layout carried over keeps every field; slots past each row's
    slot count hold only zeros."""
    _, prob = case
    ref = ref_bsr.BSRMatrix.from_csr(prob.K, block=8, dtype=jnp.float32)
    got = BSRMatrix.from_reference(ref, device="cpu")
    for f in ("blocks", "cols", "win_start", "cols_rel"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert got.blocks.dtype == torch.float32 and got.cols.dtype == torch.int32
    assert (got.n, got.win_unit, got.nnz_dense) == (
        ref.n, ref.win_unit, ref.nnz_dense
    )
    assert abs(got.to_csr() - ref.to_csr()).max() == 0
    counts = got.slot_count.long()
    past = torch.arange(got.slots)[None, :] >= counts[:, None]
    assert not got.blocks[past].any()
    assert bool((got.blocks[torch.arange(got.n_brows)[counts > 0],
                            counts[counts > 0] - 1] != 0).flatten(1).any(1).all())


def test_pad_and_unpad_match_reference():
    prob = _problem("rect2d_16x16")
    ref = ref_bsr.BSRMatrix.from_csr(prob.K, block=8, dtype=jnp.float64)
    port = BSRMatrix.from_csr(prob.K, block=8, dtype=torch.float64,
                              device="cpu")
    x = np.random.default_rng(0).standard_normal((port.n, 3))
    for v in (x, x[:, 0]):
        got = port.pad_vec(torch.from_numpy(v))
        want = np.asarray(ref.pad_vec(jnp.asarray(v)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(port.unpad_vec(got).numpy(), v)


def test_row_align():
    """row_align rounds the block-row count, as the reference's does."""
    prob = _problem("brick_6x6x6_rcm")
    for align in (1, 32):
        ref = ref_bsr.BSRMatrix.from_csr(prob.K, block=8, row_align=align,
                                         dtype=jnp.float32)
        port = BSRMatrix.from_csr(prob.K, block=8, row_align=align,
                                  device="cpu")
        assert port.n_brows == ref.n_brows
        assert abs(port.to_csr() - ref.to_csr()).max() == 0


@pytest.mark.parametrize("kernel", ["ref", "pallas"])
def test_kernel_metadata_built_for_kernel_layouts_only(kernel):
    """A "pallas" pencil's layouts carry the window metadata and slot counts
    its kernels read; a "ref" pencil's plain apply reads neither, so its
    layouts skip them."""
    from maxwell_tpu_torch.problems import RectCavity2D
    from maxwell_tpu_torch.solvers.operator import Pencil

    pen = Pencil.from_problem(RectCavity2D(nx=16, ny=16), kernel=kernel,
                              dtype=torch.float64, device="cpu")
    for A in (pen.K, pen.M):
        built = (A.slot_count is not None, A.win_start is not None,
                 A.win_unit > 0)
        assert built == ((kernel == "pallas"),) * 3
