"""BELLUnion and blocked-ELL layouts of maxwell_tpu_torch against the JAX
package's host builds: identical arrays, bitwise-identical bf16 splits,
exact CSR round trips."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.sparse.bellunion import BELLUnion as RefUnion
from maxwell_tpu.sparse.bsr import BSRMatrix as RefBSR
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.sparse.bellunion import BELLUnion
from maxwell_tpu_torch.sparse.bsr import BSRMatrix

torch.set_num_threads(1)


def _problem(case):
    if case == "brick_6x5x4_rcm":
        return RefPermuted(RefBrick(nx=6, ny=5, nz=4))
    if case == "brick_5x5x5":
        return RefBrick(nx=5, ny=5, nz=5)
    return RefRect(nx=8, ny=8)


def _random_pair(seed=7):
    """Two CSR matrices with different patterns (streams of one union)."""
    n = 300
    A = sp.random(n, n, density=0.04, format="csr", random_state=seed)
    B = sp.random(n, n, density=0.03, format="csr", random_state=seed + 1)
    return A, B


BUILDS = {
    "brick_6x5x4_rcm": dict(),
    "brick_5x5x5": dict(),
    "rect2d_8x8": dict(),
    "random_cl256": dict(chunk_lanes=256, pack=2),
    "random_pack1": dict(chunk_lanes=512, pack=1),
}


def _build_both(case):
    kw = BUILDS[case]
    if case.startswith("random"):
        A, B = _random_pair()
    else:
        cav = _problem(case)
        A, B = cav.K, cav.M
    ref = RefUnion.from_csr(
        A, block=8, dtype=jnp.float32, B=B, to_device=False, **kw
    )
    port = BELLUnion.from_csr(
        A, block=8, dtype=torch.float32, B=B, device="cpu", **kw
    )
    return A, B, ref, port


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_union_arrays_identical(case):
    _, _, ref, port = _build_both(case)
    for f in ("vals", "vals_b", "ucols", "tile_of", "first"):
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f
        )
    for f in ("n", "n_tiles", "b", "cl", "pack", "n_padded", "n_chunks"):
        assert getattr(port, f) == getattr(ref, f), f
    # tile_ptr: first chunk of each tile, consistent with tile_of/first
    tp = port.tile_ptr.numpy()
    assert tp[0] == 0 and tp[-1] == port.n_chunks
    assert np.all(np.diff(tp) >= 1)  # every tile has >= 1 chunk
    np.testing.assert_array_equal(np.flatnonzero(np.asarray(ref.first)), tp[:-1])


@pytest.mark.parametrize("case", ["brick_6x5x4_rcm", "random_cl256"])
def test_bf16x3_split_bitwise(case):
    """torch.bfloat16 rounding == ml_dtypes' (round to nearest even)."""
    _, _, ref, port = _build_both(case)
    ref3, port3 = ref.bf16x3(), port.bf16x3()
    for f in ("vals_h", "vals_l", "vals_b_h", "vals_b_l"):
        r = np.asarray(getattr(ref3, f))
        assert r.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(
            getattr(port3, f).view(torch.int16).numpy(), r.view(np.int16),
            err_msg=f,
        )


@pytest.mark.parametrize("case", ["brick_6x5x4_rcm", "rect2d_8x8", "random_cl256"])
def test_union_to_csr_round_trip(case):
    A, B, _, port = _build_both(case)
    for stream, C in (("a", A), ("b", B)):
        diff = port.to_csr(stream) - sp.csr_matrix(C, dtype=np.float32)
        assert abs(diff).max() == 0


def test_union_from_reference_identical():
    """A JAX host build (with its bf16 split) carried over leaf by leaf."""
    _, _, ref, port = _build_both("brick_6x5x4_rcm")
    got = BELLUnion.from_reference(ref.bf16x3(), device="cpu")
    want = port.bf16x3()
    for f in BELLUnion._TENSORS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (got.n, got.n_tiles, got.cl, got.pack, got.n_cols) == (
        want.n, want.n_tiles, want.cl, want.pack, want.n_cols
    )


@pytest.mark.parametrize("block,align", [(4, 4), (8, None)])
def test_bsr_layout_matches_reference(block, align):
    cav = RefPermuted(RefBrick(nx=6, ny=5, nz=4))
    ref = RefBSR.from_csr(cav.K, block=block, align_slots=align,
                          dtype=jnp.float64)
    port = BSRMatrix.from_csr(cav.K, block=block, align_slots=align,
                              dtype=torch.float64, device="cpu")
    # same padding and slot count; the order of blocks within a block-row
    # may differ (the reference fills it with its native converter)
    assert port.n_padded == ref.n_padded and port.slots == ref.slots
    assert abs(port.to_csr() - ref.to_csr()).max() == 0
    assert abs(port.to_csr() - cav.K).max() == 0
