"""The row-sharded partitioner, halo exchange and sharded applies of
maxwell_tpu_torch (dist/, kernels/halo.py) against the JAX package's on its
8-device CPU mesh (tests/conftest.py): the same H, L, permutation,
projector data and per-shard layouts; the same halo-extended buffers under
every transport (the ring shift's and the fused overlap's plain versions
here); the same sharded K and M products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import PartitionSpec as P

from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist import partition_problem as ref_partition
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.solvers.dist_solve import spmm_dist as ref_spmm_dist
from maxwell_tpu_torch.dist import (
    make_mesh,
    mesh_topology_report,
    partition_problem,
)
from maxwell_tpu_torch.kernels import halo
from maxwell_tpu_torch.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu_torch.solvers.dist_solve import spmm_dist

torch.set_num_threads(1)

D = 8
# f64 to roundoff; f32 at the reference's own distributed bound
# (tests/distributed/test_config4_union.py:48)
RTOL = {torch.float64: 1e-12, torch.float32: 2e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
# (kernel, dtype) of each partition kind
KINDS = {"ref": torch.float64, "pallas": torch.float32,
         "union": torch.float32}


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    return ref_make_mesh(D)


def _problems(name):
    if name == "brick6":  # deep halo (H > L) at 8 shards
        return RefBrick(nx=6, ny=6, nz=6), BrickCavity3D(nx=6, ny=6, nz=6)
    return RefRect(nx=16, ny=16), RectCavity2D(nx=16, ny=16)  # shallow


_CACHE = {}


def _pair(name, kernel, halo_impl="ppermute", reorder=True, dcn_links=None,
          ref_kernel=None):
    """(reference, port) partitions. ref_kernel: the reference's kernel, if
    not `kernel` (its "pallas" applies run only on a TPU; its "ref" kernel
    at b = 8 has the same layout)."""
    key = (name, kernel, halo_impl, reorder, dcn_links, ref_kernel)
    if key not in _CACHE:
        ref_prob, port_prob = _problems(name)
        dt = KINDS[kernel]
        ref = ref_partition(ref_prob, D, kernel=ref_kernel or kernel,
                            block=8 if kernel == "pallas" else None,
                            dtype=JDT[dt], reorder=reorder,
                            halo_impl=halo_impl, dcn_links=dcn_links)
        port = partition_problem(port_prob, D, kernel=kernel, dtype=dt,
                                 reorder=reorder, halo_impl=halo_impl,
                                 dcn_links=dcn_links, device="cpu")
        _CACHE[key] = (ref, port)
    return _CACHE[key]


def _block_csr(blocks, cols, nrows, ncols, b):
    """CSR (nrows*b, ncols*b) of the nonzero blocks whose column lies in
    [0, ncols)."""
    nz = np.abs(blocks).max(axis=(2, 3)) > 0
    nz &= (cols >= 0) & (cols < ncols)
    r, s = np.nonzero(nz)
    ii, jj = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    rows = (r[:, None, None] * b + ii).ravel()
    cs = (cols[r, s][:, None, None] * b + jj).ravel()
    return sp.coo_matrix((blocks[r, s].ravel(), (rows, cs)),
                         shape=(nrows * b, ncols * b)).tocsr()


def _shard_pieces_ref(ref, which, d):
    L, H, b = ref.L, ref.H, ref.b
    rows = slice(d * L, (d + 1) * L)
    bi = np.asarray(getattr(ref, f"{which}_blocks"))[rows]
    ci = np.asarray(getattr(ref, f"{which}_cols"))[rows]
    bb = np.asarray(getattr(ref, f"{which}_blocks_bnd"))[rows]
    cb = np.asarray(getattr(ref, f"{which}_cols_bnd"))[rows]
    return (_block_csr(bi, ci, L, L, b),
            _block_csr(bb, cb - L, L, 2 * H, b))


def _shard_pieces_port(port, which, d):
    L, H, b = port.L, port.H, port.b
    rows = slice(d * L, (d + 1) * L)
    A = getattr(port, f"{which}_int")
    inner = _block_csr(A.blocks[rows].numpy(), A.cols[rows].numpy() - d * L,
                       L, L, b)
    B = getattr(port, f"{which}_bnd")
    if B is None:
        return inner, sp.csr_matrix((L * b, 0))
    cb = B.cols[rows].numpy() - d * (L + 2 * H + 1) - L
    return inner, _block_csr(B.blocks[rows].numpy(), cb, L, 2 * H, b)


@pytest.mark.parametrize("name", ["brick6", "rect16"])
@pytest.mark.parametrize("kernel", ["ref", "pallas", "union"])
def test_partition_matches_reference(name, kernel):
    ref, port = _pair(name, kernel)
    assert (port.D, port.L, port.H, port.b, port.n, port.n_nodes) == (
        ref.D, ref.L, ref.H, ref.b, ref.n, ref.n_nodes)
    assert port.H > port.L if name == "brick6" else port.H <= port.L
    np.testing.assert_array_equal(port.perm, ref.perm)
    n = port.n
    for f in ("head", "tail"):
        want = np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(getattr(port.proj, f).numpy(), want[:n])
        assert (want[n:] == port.n_nodes).all()
    w = np.asarray(ref.weight)
    np.testing.assert_array_equal(port.proj.weight.numpy(),
                                  w[:n].astype(w.dtype))
    assert port.proj.n_padded == port.global_rows == D * ref.L * ref.b
    if kernel == "union":
        for part, cl, pack, step in (
            ("i", ref.u_cl, ref.u_pack, ref.L),
            ("b", ref.ub_cl, ref.ub_pack, 2 * ref.H),
        ):
            U = port.Ui if part == "i" else port.Ub
            np.testing.assert_array_equal(
                U.vals.numpy(), np.asarray(getattr(ref, f"U{part}_vals")))
            np.testing.assert_array_equal(
                U.vals_b.numpy(), np.asarray(getattr(ref, f"U{part}_vals_b")))
            np.testing.assert_array_equal(
                U.first.numpy(), np.asarray(getattr(ref, f"U{part}_first")))
            assert (U.cl, U.pack) == (cl, pack)
            # per shard: the reference's local columns and tiles, moved to
            # the shard's place in the stacked buffers
            NC = U.n_chunks // D
            shard = np.repeat(np.arange(D), NC)
            np.testing.assert_array_equal(
                U.ucols.numpy(),
                np.asarray(getattr(ref, f"U{part}_ucols"))
                + (shard * step)[:, None])
            np.testing.assert_array_equal(
                U.tile_of.numpy(),
                np.asarray(getattr(ref, f"U{part}_tile"))
                + shard * (ref.L * ref.b // 128))
        return
    for which in ("K", "M"):
        for d in range(D):
            for got, want in zip(_shard_pieces_port(port, which, d),
                                 _shard_pieces_ref(ref, which, d)):
                assert got.shape == want.shape
                diff = abs(got - want)
                assert diff.max() <= RTOL[KINDS[kernel]] * abs(want).max()


def test_union_partition_refuses_f64():
    with pytest.raises(ValueError, match="f32"):
        partition_problem(RectCavity2D(nx=8, ny=8), D, kernel="union",
                          dtype=torch.float64, device="cpu")


def test_mesh_topology_report():
    rep = mesh_topology_report(make_mesh(D, "cpu"))
    assert rep == {"devices": D, "hosts": 1, "neighbor_links": D - 1,
                   "dcn_links": 0, "ici_links": D - 1,
                   "dcn_link_positions": [],
                   "real": {"devices": 1, "hosts": 1}}
    port = partition_problem(RectCavity2D(nx=8, ny=8), D,
                             mesh=make_mesh(D, "cpu"))
    assert port.dcn_links == () and port.device.type == "cpu"


def _ref_exchange(ref, mesh, X):
    f = jax.shard_map(
        lambda p, Xl: p.exchange_halos(Xl), mesh=mesh,
        in_specs=(ref.partition_specs(), P(ref.axis, None)),
        out_specs=P(ref.axis, None), check_vma=False)
    return np.asarray(jax.jit(f)(ref, X))


HALO_CASES = {
    # case: (problem, kernel, halo_impl, dcn_links)
    "ppermute": ("rect16", "ref", "ppermute", None),
    "rdma": ("rect16", "ref", "rdma", None),
    "dcn": ("rect16", "ref", "ppermute", (1, 3)),
    "deep": ("brick6", "ref", "ppermute", None),
    "ppermute_b8": ("rect16", "pallas", "ppermute", None),
    "rdma_b8": ("rect16", "pallas", "rdma", None),
}


@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_exchange_matches_reference(mesh, case):
    """Every transport gives the reference's halo-extended buffers bit for
    bit (they only copy), and its checksum against the gather oracle is
    0."""
    name, kernel, impl, dcn = HALO_CASES[case]
    _, port = _pair(name, kernel, impl, dcn_links=dcn)
    ref, _ = _pair(name, kernel, "ppermute", ref_kernel="ref")
    X = np.random.default_rng(0).standard_normal((port.global_rows, 3))
    X = X.astype(np.float32 if kernel == "pallas" else np.float64)
    want = _ref_exchange(ref, mesh, jnp.asarray(X))
    halo.reset_counts()
    got = port.exchange_halos(torch.from_numpy(X))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (D * (port.Lb + 2 * port.Hb + port.b), 3)
    assert port.halo_checksum(torch.from_numpy(X)).item() == 0.0
    # only the "rdma" transport of a shallow halo takes the ring shift
    c = halo.counts()
    assert c["ring_shift_ref"] == (2 if impl == "rdma" else 0)
    vec = port.exchange_halos(torch.from_numpy(X[:, 1].copy()))
    np.testing.assert_array_equal(vec.numpy(), want[:, 1])


def test_ring_shift_chain_ends_are_zero():
    """The first shard's left half and the last shard's right half are
    written as zeros, whatever the output held."""
    X = torch.arange(4 * 6 * 2, dtype=torch.float64).reshape(24, 2) + 1.0
    out = halo.ring_shift(X, 4, 2).reshape(4, 4, 2)
    assert not out[0, :2].any() and not out[-1, 2:].any()
    np.testing.assert_array_equal(out[1, :2], X[4:6])  # shard 0's last 2
    np.testing.assert_array_equal(out[1, 2:], X[12:14])  # shard 2's first 2
    full = halo.ring_shift(X, 4, 2, own=True, pad_rows=3).reshape(4, 13, 2)
    np.testing.assert_array_equal(full[:, :6].reshape(24, 2), X)
    assert not full[:, 10:].any()


SPMM_CASES = [
    ("rect16", "ref", "ppermute"), ("rect16", "ref", "rdma"),
    ("brick6", "ref", "ppermute"),
    ("rect16", "pallas", "ppermute"), ("rect16", "pallas", "rdma"),
    ("rect16", "union", "ppermute"), ("rect16", "union", "rdma"),
    ("rect16", "union", "rdma_overlap"), ("brick6", "union", "ppermute"),
]


@pytest.mark.parametrize("name,kernel,impl", SPMM_CASES)
def test_spmm_dist_matches_reference(mesh, name, kernel, impl):
    """Sharded K @ X and M @ X, and the fused KM_mm, against the
    reference's sharded products (its "ppermute" transport; for "pallas"
    its "ref" kernel on the same 8x8 blocked-ELL partition)."""
    ref, _ = _pair(name, kernel, "ppermute",
                   ref_kernel="ref" if kernel == "pallas" else None)
    _, port = _pair(name, kernel, impl)
    dt = KINDS[kernel]
    X = np.random.default_rng(1).standard_normal((port.global_rows, 3))
    X[port.n:] = 0.0
    X = X.astype(np.float32 if dt == torch.float32 else np.float64)
    Xt = torch.from_numpy(X)
    halo.reset_counts()
    KX, MX = port.KM_mm(Xt)
    for which, got in (("K", KX), ("M", MX)):
        want = np.asarray(ref_spmm_dist(ref, mesh, jnp.asarray(X), which))
        err = np.abs(got.numpy() - want).max()
        assert err <= RTOL[dt] * np.abs(want).max()
        np.testing.assert_array_equal(
            spmm_dist(port, None, Xt, which).numpy(), got.numpy())
    c = halo.counts()
    # KM_mm and the two spmm_dist calls
    assert c["union_interior_overlap_ref"] == 3 * (impl == "rdma_overlap")


@pytest.mark.parametrize("kernel", ["pallas", "union"])
def test_rdma_transports_bit_equal_ppermute(kernel):
    """"rdma" and "rdma_overlap" give the "ppermute" products bit for bit
    (the reference asserts it for its kernels,
    tests/distributed/test_rdma_overlap.py)."""
    _, base = _pair("rect16", kernel, "ppermute")
    X = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (base.global_rows, 2)).astype(np.float32))
    for impl in ("rdma", "rdma_overlap"):
        _, port = _pair("rect16", kernel, impl)
        for a, b in zip(port.KM_mm(X), base.KM_mm(X)):
            assert torch.equal(a, b)
        assert torch.equal(port.M_mm(X[:, 0]), base.M_mm(X[:, 0]))


def test_dist_reductions_are_shard_sums():
    _, port = _pair("rect16", "ref", "ppermute")
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.standard_normal((port.global_rows, 3)))
    B = torch.from_numpy(rng.standard_normal((port.global_rows, 2)))
    np.testing.assert_allclose(port.dot_mm(A, B), A.T @ B, rtol=1e-13)
    np.testing.assert_allclose(port.dot_cols(A, A), (A * A).sum(0),
                               rtol=1e-13)
    np.testing.assert_allclose(port.dot_vv(A[:, 0], A[:, 1]),
                               A[:, 0] @ A[:, 1], rtol=1e-12)
    Xo = rng.standard_normal((port.n, 2))
    np.testing.assert_array_equal(
        port.extract_vectors(port.inject_vectors(Xo)), Xo)


def test_rdma_exchange_gets_contiguous_rows(monkeypatch):
    """A column of a block (a strided view) reaches the ring-shift kernel,
    which takes contiguous rows only, as a contiguous tensor."""
    _, port = _pair("rect16", "pallas", "rdma")
    seen = []
    real = halo.ring_shift

    def spy(X, *args, **kwargs):
        seen.append(X.is_contiguous())
        return real(X, *args, **kwargs)

    monkeypatch.setattr(halo, "ring_shift", spy)
    X = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (port.global_rows, 3)).astype(np.float32))
    y = port.M_mm(X[:, 1])
    np.testing.assert_array_equal(y, port.M_mm(X[:, 1].contiguous()))
    port.exchange_halos(X[:, 2])
    assert len(seen) == 3 and all(seen)
