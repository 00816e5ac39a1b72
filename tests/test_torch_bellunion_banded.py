"""BELLUnion.pad_chunks, BELLUnion.banded and the banded union apply (K7)
of maxwell_tpu_torch against the JAX package: the same padded layouts, the
same band split (values, columns, tiles, windows), and the banded apply's
plain version against the JAX banded kernel in interpret mode and against
the full-X apply."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from maxwell_tpu.kernels.spmm import (
    bellunion_matmat_banded as ref_banded_apply,
)
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.sparse.bellunion import BELLUnion as RefUnion
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.kernels import spmm
from maxwell_tpu_torch.sparse.bellunion import BELLUnion

torch.set_num_threads(1)

# f32 summation order differs from the JAX kernel's (the reference's own
# bounds, tests/unit/test_pallas_spmm.py)
TOL = {"highest": 1e-5, "b3": 2e-5}
# X rows a band may read: budget_bytes // (4 m) with m = 8; small enough
# that the 8^3 RCM brick (11 tiles) splits into several bands
BUDGET = 4 * 8 * 700


def _bits(a) -> np.ndarray:
    """Raw bits of a bf16 array (ml_dtypes) or tensor."""
    if torch.is_tensor(a):
        return a.cpu().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.fixture(scope="module")
def layouts():
    cav = RefPermuted(RefBrick(nx=8, ny=8, nz=8))
    ref = RefUnion.from_csr(cav.K, block=8, dtype=jnp.float32, B=cav.M,
                            to_device=False)
    port = BELLUnion.from_csr(cav.K, block=8, dtype=torch.float32, B=cav.M,
                              device="cpu")
    return cav, ref, port


@pytest.mark.parametrize("extra", [0, 1, 13])
def test_pad_chunks_matches_reference(layouts, extra):
    _, ref, port = layouts
    NC = port.n_chunks + extra
    r, p = ref.pad_chunks(NC), port.bf16x3().pad_chunks(NC)
    for f in ("vals", "vals_b", "ucols", "tile_of", "first"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(r, f)))
    assert p.n_chunks == NC
    # the bf16 splits are padded with zeros like the f32 streams
    for f in ("vals_h", "vals_l", "vals_b_h", "vals_b_l"):
        assert getattr(p, f).shape == p.vals.shape
        assert not getattr(p, f)[port.n_chunks * 128:].any()
    # tile_ptr is derived again: the padding chunks join the last tile;
    # tile_end keeps every tile's live end, where the kernels stop
    assert p.tile_ptr[-1].item() == NC
    np.testing.assert_array_equal(p.tile_ptr[:-1].numpy(),
                                  port.tile_ptr[:-1].numpy())
    if extra:
        np.testing.assert_array_equal(p.tile_end.numpy(),
                                      port.tile_ptr[1:].numpy())
    else:
        assert p.tile_end is None
    # zero chunks add exact zeros: the product is unchanged
    X = torch.from_numpy(
        np.random.default_rng(extra).standard_normal((port.n_padded, 3))
    ).float()
    np.testing.assert_array_equal(spmm.bellunion_matmat_ref(p, X, "b"),
                                  spmm.bellunion_matmat_ref(port, X, "b"))


def test_pad_chunks_refuses_to_shrink(layouts):
    _, _, port = layouts
    assert port.pad_chunks(port.n_chunks) is port
    with pytest.raises(ValueError, match="shrink"):
        port.pad_chunks(port.n_chunks - 1)


@pytest.mark.parametrize("split_bf16", [False, True])
def test_banded_matches_reference(layouts, split_bf16):
    cav, ref, port = layouts
    rb = ref.banded(8, budget_bytes=BUDGET, split_bf16=split_bf16)
    pb = port.banded(8, budget_bytes=BUDGET, split_bf16=split_bf16)
    assert len(pb.bands) == len(rb.bands) > 2
    assert pb.col_starts == rb.col_starts
    assert pb.col_rows == rb.col_rows
    assert (pb.n, pb.b, pb.n_padded) == (rb.n, rb.b, rb.n_padded)
    K = sp.csr_matrix(cav.K)
    K.resize((port.n_padded, port.n_padded))
    row = 0
    for p, r, cs, rows in zip(pb.bands, rb.bands, pb.col_starts,
                              pb.col_rows):
        for f in ("vals", "vals_b", "ucols", "tile_of", "first"):
            np.testing.assert_array_equal(getattr(p, f).numpy(),
                                          np.asarray(getattr(r, f)))
        assert (p.n, p.n_tiles, p.cl, p.pack) == (r.n, r.n_tiles, r.cl,
                                                  r.pack)
        # a band is rectangular: its columns are its X window
        assert p.n_cols == rows == p.n_cols_padded
        want = K[row : row + p.n, cs : cs + rows]
        assert abs(p.to_csr() - want).max() <= 1e-6 * abs(K).max()
        row += p.n
        if split_bf16:
            for f in ("vals_h", "vals_l", "vals_b_h", "vals_b_l"):
                np.testing.assert_array_equal(_bits(getattr(p, f)),
                                              _bits(getattr(r, f)))
        else:
            assert p.vals_h is None


def test_band_streams_are_views(layouts):
    _, _, port = layouts
    full = port.bf16x3()
    pb = full.banded(8, budget_bytes=BUDGET, split_bf16=True)
    for bp in pb.bands:
        for f in ("vals", "vals_b", "vals_h", "vals_l"):
            assert getattr(bp, f).untyped_storage().data_ptr() == getattr(
                full, f).untyped_storage().data_ptr()


@pytest.mark.parametrize("precision", ["highest", "b3"])
def test_banded_apply_matches_reference(layouts, precision):
    """The K7 plain version against the JAX banded kernel (interpret mode)
    and against the full-X plain apply, on stream a (K) and b (M)."""
    _, ref, port = layouts
    split = precision == "b3"
    rb = ref.banded(8, budget_bytes=BUDGET, split_bf16=split)
    pb = port.banded(8, budget_bytes=BUDGET, split_bf16=split)
    full = port.bf16x3() if split else port
    X = np.random.default_rng(3).standard_normal((port.n_padded, 8)).astype(
        np.float32)
    Xt = torch.from_numpy(X)
    spmm.reset_counts()
    for stream in "ab":
        want = np.asarray(ref_banded_apply(
            rb, jnp.asarray(X), interpret=True, stream=stream,
            precision=precision))
        got = spmm.bellunion_matmat_banded(pb, Xt, stream, precision)
        whole = spmm.bellunion_matmat_ref(full, Xt, stream, precision)
        assert got.shape == (pb.n_padded, 8)
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= TOL[precision] * scale
        assert (got - whole).abs().max().item() <= 1e-6 * scale
    c = spmm.counts()
    assert c["bellunion_matmat_banded_ref"] == 2
    assert c["bellunion_matmat_banded"] == 0


def test_banded_apply_pads_x_only_past_its_end(layouts):
    """X with only n rows: the last window runs past it and reads zeros."""
    cav, _, port = layouts
    pb = port.banded(8, budget_bytes=BUDGET)
    n = cav.K.shape[0]
    X = torch.from_numpy(
        np.random.default_rng(4).standard_normal((n, 2))).float()
    Xp = torch.nn.functional.pad(X, (0, 0, 0, port.n_padded - n))
    np.testing.assert_array_equal(spmm.bellunion_matmat_banded(pb, X),
                                  spmm.bellunion_matmat_banded(pb, Xp))


def test_banded_refuses_rectangular_layouts():
    A = sp.random(256, 300, density=0.02, format="csr", random_state=1)
    with pytest.raises(ValueError, match="square"):
        BELLUnion.from_csr(A, ncols=300, device="cpu").banded(4)
