"""The live form of the BELLUnion layout (BELLUnion.live: the live 8-row x
16-lane sub-blocks, their values compacted, and the X runs each chunk needs;
what the CUDA union kernels read): its compacted streams scatter back to the
full streams bit for bit through every way a layout is made, its lists match
a direct count, and the product computed from it alone
(kernels/spmm.py::_union_live_ref) matches the JAX package's Pallas kernels
in interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from maxwell_tpu.kernels import spmm as ref_spmm
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.sparse.bellunion import BELLUnion as RefUnion
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.dist import partition_problem
from maxwell_tpu_torch.dist.partition import _stack_union
from maxwell_tpu_torch.kernels import halo, spmm
from maxwell_tpu_torch.problems import RectCavity2D
from maxwell_tpu_torch.sparse.bellunion import _VALUE_STREAMS, BELLUnion

torch.set_num_threads(1)

# f32 summation order differs from the reference's (reference tests :211
# and :408 hold the TPU kernels to scipy at the same bounds)
TOL = {"highest": 1e-5, "b3": 2e-5}
CASES = ("brick_6x5x4_rcm", "pair", "brick_8_rcm")


def _matrices(case):
    """(A, B): K and M of an RCM brick, or two random CSRs whose patterns
    differ (sub-blocks live in one stream only)."""
    if case == "pair":
        n = 300
        return (sp.random(n, n, density=0.04, format="csr", random_state=7),
                sp.random(n, n, density=0.03, format="csr", random_state=8))
    g = {"brick_6x5x4_rcm": (6, 5, 4), "brick_8_rcm": (8, 8, 8)}[case]
    cav = RefPermuted(RefBrick(nx=g[0], ny=g[1], nz=g[2]))
    return cav.K, cav.M


@pytest.fixture(scope="module", params=CASES)
def layouts(request):
    """(case, JAX layout with its bf16 split, the port's from_csr layout
    with its split)."""
    A, B = _matrices(request.param)
    ref = RefUnion.from_csr(
        A, block=8, dtype=jnp.float32, B=B, to_device=False
    ).bf16x3().to_device()
    port = BELLUnion.from_csr(A, B=B, device="cpu").bf16x3()
    return request.param, ref, port


def _coords(L, n_chunks):
    """(chunk, row group, run) of each live sub-block, from the lists."""
    grp = np.repeat(np.arange(n_chunks * 16), np.diff(L.sb_ptr.numpy()))
    k = grp // 16
    run = L.xr_run.numpy()[L.xr_ptr.numpy()[k] + L.sb_run.numpy()]
    return k, grp % 16, run


def _scatter(A, v):
    """A compacted (NSB, 8, 16) stream written back into a zero full
    (NC * 128, cl) stream."""
    k, r, s = _coords(A.live, A.n_chunks)
    full = torch.zeros((A.n_chunks, 16, 8, A.cl // 16, 16), dtype=v.dtype)
    full[k, r, :, s, :] = v
    return full.reshape(A.n_chunks * 128, A.cl)


def _assert_scatters_back(A):
    present = [f for f in _VALUE_STREAMS if getattr(A, f) is not None]
    assert present == [f for f in _VALUE_STREAMS
                       if getattr(A.live, f) is not None]
    for f in present:
        got, want = _scatter(A, getattr(A.live, f)), getattr(A, f)
        if want.dtype == torch.bfloat16:  # bits, signed zeros included
            got, want = got.view(torch.int16), want.view(torch.int16)
        assert torch.equal(got, want), f


def _direct_lists(A):
    """sb_ptr, sb_run, xr_ptr, xr_run and x_max counted block by block."""
    vals = [getattr(A, f).numpy() for f in ("vals", "vals_b")
            if getattr(A, f) is not None]
    R = A.cl // 16
    sb_ptr, sb_run, xr_ptr, xr_run = [0], [], [0], []
    for k in range(A.n_chunks):
        live = np.zeros((16, R), bool)
        for r in range(16):
            for s in range(R):
                live[r, s] = any(
                    np.any(v[128 * k + 8 * r: 128 * k + 8 * r + 8,
                             16 * s: 16 * s + 16] != 0) for v in vals)
        runs = list(np.flatnonzero(live.any(0)))
        xr_run += runs
        xr_ptr.append(len(xr_run))
        for r in range(16):
            sb_run += [runs.index(s) for s in np.flatnonzero(live[r])]
            sb_ptr.append(len(sb_run))
    return sb_ptr, sb_run, xr_ptr, xr_run, max(np.diff(xr_ptr))


def _banded(A):
    """A's bands at m 9 with the smallest X budget that holds its widest
    tile window, so that most tiles get a band of their own."""
    uc, tof = A.ucols.numpy(), A.tile_of.numpy()
    win = max(uc[tof == t].max() + 1 - uc[tof == t].min()
              for t in range(A.n_tiles)) * A.b
    return A.banded(9, budget_bytes=4 * 9 * int(win), split_bf16=True)


def _made(port, ref, how):
    """The layouts `how` makes from the port's (or the reference's)."""
    if how == "from_csr":
        return [port]
    if how == "from_reference":
        return [BELLUnion.from_reference(ref, device="cpu")]
    if how == "to":
        return [port.to("cpu")]
    if how == "bf16x3":  # a layout built without the split, split after
        unsplit = dict(vals_h=None, vals_l=None, vals_b_h=None,
                       vals_b_l=None)
        return [dataclasses.replace(
            port, **unsplit,
            live=dataclasses.replace(port.live, **unsplit)).bf16x3()]
    if how == "pad_chunks":
        return [port.pad_chunks(port.n_chunks + 3)]
    if how == "banded":
        return list(_banded(port).bands)
    # two layouts stacked as the distributed partitioner stacks its shards
    NC = port.n_chunks + 2
    return [_stack_union([port.pad_chunks(NC), port.pad_chunks(NC)],
                         port.n_cols_padded)]


@pytest.mark.parametrize("how", ["from_csr", "from_reference", "to",
                                 "bf16x3", "pad_chunks", "banded", "stack"])
def test_live_scatters_back_to_full_streams(layouts, how):
    case, ref, port = layouts
    made = _made(port, ref, how)
    if how == "banded" and case != "pair":  # RCM: narrow tile windows
        assert len(made) > 1
    for A in made:
        _assert_scatters_back(A)


@pytest.mark.parametrize("how", ["from_csr", "pad_chunks", "banded",
                                 "stack"])
def test_live_lists_match_direct_count(layouts, how):
    _, ref, port = layouts
    for A in _made(port, ref, how):
        sb_ptr, sb_run, xr_ptr, xr_run, x_max = _direct_lists(A)
        L = A.live
        assert L.sb_ptr.tolist() == sb_ptr and L.sb_run.tolist() == sb_run
        assert L.xr_ptr.tolist() == xr_ptr and L.xr_run.tolist() == xr_run
        assert L.x_max == x_max
        assert all(t.dtype == torch.int32 for t in (
            L.sb_ptr, L.sb_run, L.xr_ptr, L.xr_run))


def test_pair_has_blocks_live_in_one_stream_only():
    """The case whose patterns differ exercises the union of the streams:
    some live sub-blocks are all zero in one of them."""
    A, B = _matrices("pair")
    L = BELLUnion.from_csr(A, B=B, device="cpu").live
    za = (L.vals == 0).all(2).all(1)
    zb = (L.vals_b == 0).all(2).all(1)
    assert za.any() and zb.any() and not (za & zb).any()


def test_band_live_streams_are_views(layouts):
    _, _, port = layouts
    AB = _banded(port)
    base = port.live.vals.untyped_storage().data_ptr()
    for bp in AB.bands:
        assert bp.live.vals.untyped_storage().data_ptr() == base


def _x(rows, m, seed):
    return np.random.default_rng(seed).standard_normal((rows, m)).astype(
        np.float32)


@pytest.mark.parametrize("precision", ["highest", "b3"])
@pytest.mark.parametrize("stream", ["a", "b"])
@pytest.mark.parametrize("m", [1, 9, 17])
def test_live_product_matches_pallas_interpret(layouts, m, stream,
                                               precision):
    """Y from the live form alone (the kernels' reads) against the JAX
    bellunion_matmat_pallas, the port's layout carried over from it."""
    _, ref, _ = layouts
    port = BELLUnion.from_reference(ref, device="cpu")
    X = _x(port.n_cols_padded, m, seed=m)
    want = np.asarray(ref_spmm.bellunion_matmat_pallas(
        ref, jnp.asarray(X), interpret=True, stream=stream,
        precision=precision))
    got = spmm._union_live_ref(port, torch.from_numpy(X), stream,
                               precision)[0].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[precision] * np.abs(want).max()


@pytest.mark.parametrize("precision", ["highest", "b3"])
@pytest.mark.parametrize("m", [1, 9, 17])
def test_live_km_product_matches_pallas_interpret(layouts, m, precision):
    """Both streams from the live form against the JAX
    bellunion_km_matmat_pallas."""
    _, ref, port = layouts
    X = _x(port.n_padded, m, seed=m + 1)
    want = [np.asarray(w) for w in ref_spmm.bellunion_km_matmat_pallas(
        ref, jnp.asarray(X), interpret=True, precision=precision)]
    got = spmm._union_live_ref(port, torch.from_numpy(X), "ab", precision)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= TOL[precision] * np.abs(
            w).max()


def test_distributed_stack_carries_live_form():
    """The union partitioner's stacked interior and boundary layouts:
    lists per shard after shard, scattering back, and the product from the
    live form within the union bound of the plain one."""
    dp = partition_problem(RectCavity2D(nx=16, ny=16), 8, kernel="union",
                           dtype=torch.float32, device="cpu")
    for A in (dp.Ui, dp.Ub):
        _assert_scatters_back(A)
        sb_ptr, sb_run, xr_ptr, xr_run, x_max = _direct_lists(A)
        assert A.live.sb_ptr.tolist() == sb_ptr
        assert A.live.xr_run.tolist() == xr_run
        X = torch.from_numpy(_x(A.n_cols_padded, 9, seed=4))
        for got, want in zip(spmm._union_live_ref(A, X, "ab", "highest"),
                             spmm._union_ref(A, X, "ab", "highest")):
            assert (got - want).abs().max() <= TOL["highest"] * want.abs(
            ).max()


@pytest.mark.parametrize("entry", ["matmat", "km_matmat", "matvec",
                                   "overlap"])
def test_kernel_path_without_live_form_raises(layouts, entry):
    """A layout without its live form reaches no kernel: the wrappers raise
    before any build or launch (meta tensors stand in for CUDA ones)."""
    _, _, port = layouts
    A = dataclasses.replace(port, live=None)
    X = torch.empty((port.n_padded, 4), device="meta")
    with pytest.raises(ValueError, match="live"):
        if entry == "matmat":
            spmm.bellunion_matmat(A, X)
        elif entry == "km_matmat":
            spmm.bellunion_km_matmat(A, X, precision="b3")
        elif entry == "matvec":
            spmm.bellunion_matvec(A, X[:, 0])
        else:
            halo.union_interior_overlap(A, X, 1, 0)
