"""Block-row partitioner and the distributed pencil (maxwell_tpu/dist/
partition.py), in a stacked view, on one process or across processes.

Host side (`partition_problem`): split the assembled K and M into D
contiguous block-row shards, compute the uniform halo depth H (the largest
off-shard block-row distance any stored nonzero reaches), and split each
shard's rows into an INTERIOR part (columns among its own rows) and a
BOUNDARY part (columns in the H block rows on either side). The host code
is the reference's, so H, L, the split and each shard's remapped columns
are the reference's.

Device side (`DistPencil`): the reference runs its solvers per shard under
shard_map, with psum reductions and ppermute (or remote-DMA) halo
exchanges. Here a process holds Dl consecutive shards of the D: all of them
(one process, on one device), or D / P of them on each of P processes
(dist/procs.py, a mesh with procs P: shards [d0, d0 + Dl), d0 = rank Dl).
The pencil works on the STACKED view the reference's shard_map assembles:
vectors are (Dl Lb, m) tensors, local shard j (global d0 + j) owns rows
[j Lb, (j + 1) Lb), and n_padded is Dl Lb, so the single-device solvers run
unchanged on it, in step on every rank. A reduction takes each shard's
partial sum (one product or sum a shard, the same call whatever P is),
gathers the D partials of all ranks over the gloo group (host copies) and
adds them in shard order: the psum, in a fixed order, without atomics, so P
processes give the one-process view's bits, and every rank the same bits,
on which it takes its host decisions. The shards' layouts are stacked into
one layout per part whose columns index a stacked buffer, so one launch
applies every local shard:

  kernel="ref" / "pallas"  blocked-ELL (BSRMatrix): the interior columns
      index the stacked X itself; the boundary columns index the stacked
      halo-extended buffer, per shard [own L | left H | right H | zero 1]
      block rows (the reference's local layout), which one halo exchange
      writes. "pallas" applies through the blocked-ELL kernels (K8, and K10
      for a vector), "ref" through the plain gather + einsum (f64).
  kernel="union"  BELLUnion layouts carrying K (stream a) and M (stream b):
      each shard's interior and boundary union layouts are padded to a
      common chunk count (`pad_chunks`) and stacked; the interior columns
      index the stacked X, the boundary columns the stacked [left | right]
      halo sections. f32, "highest" (the reference's distributed union
      path), through the union kernel (K2).

Halo transports (`halo_impl`), chosen as the reference chooses them:
  "ppermute"      plain torch (slices and torch.cat; across processes the
                  link's plain transport, kernels/halo.py HaloLink): the
                  reference's XLA collective;
  "rdma"          the ring-shift kernel (K6, kernels/halo.py), across
                  processes a push into the neighbours' buffers;
  "rdma_overlap"  union pencils: the fused interior SpMM + halo copy (K5);
                  other pencils take the "ppermute" transport, as in the
                  reference.
A halo deeper than a shard (H > L, tiny or unordered problems) takes the
gather window (plain torch; across processes on an all-gather of X), and
H = 0 (one shard) needs no halo. `dcn_links`, the links that cross hosts
(from the mesh's mesh_topology_report, or given as a test seam), select
the reference's DCN-first schedule: in one process plain torch on the
window's slices; across processes the link's own transport (each
transport above), which posts the sides that cross hosts first, over the
host-staged route (kernels/halo.py HaloLink), and gathers nothing. The
order of the copies changes nothing, so it equals the plain transport bit
for bit.

The gradient projector's node vectors are replicated in the reference;
here they are the projector of the whole problem, its G^T summed per node
in a fixed order (solvers/deflation.py); across processes every rank
holds all of G and G^T gathers the ranks' rows first, so P processes
project bit for bit as one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from maxwell_tpu_torch.kernels import halo as _halo
from maxwell_tpu_torch.kernels.halo import HaloLink
from maxwell_tpu_torch.solvers.cg import cg
from maxwell_tpu_torch.solvers.deflation import GradientProjector
from maxwell_tpu_torch.sparse.bsr import BSRMatrix, bsr_matmat_ref

_KERNELS = ("ref", "pallas", "union")
_HALO_IMPLS = ("ppermute", "rdma", "rdma_overlap")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _halo_depth_csr(C, n_pad: int, L: int, b: int) -> int:
    """Max off-shard block-column distance (block-row units) of any stored
    nonzero — the uniform halo depth H, computed directly from CSR."""
    C = sp.csr_matrix(C).copy()
    C.eliminate_zeros()
    C.resize((n_pad, n_pad))
    if C.nnz == 0:
        return 0
    counts = np.diff(C.indptr)
    brow = np.repeat(np.arange(n_pad) // b, counts)
    bcol = C.indices // b
    lo = (brow // L) * L
    d = np.maximum(lo - bcol, bcol - (lo + L - 1))
    return max(int(d.max()), 0)


def _shard_int_bnd_csr(C, D: int, Lb: int, Hb: int, n_pad: int):
    """Per-shard (interior, boundary) CSR pieces in the LOCAL layouts:
    interior (Lb, Lb) over own rows/cols; boundary (Lb, 2*Hb) whose columns
    are [left halo | right halo]. Ends of the chain get zero columns."""
    C = sp.csr_matrix(C)
    C.resize((n_pad, n_pad))
    ints, bnds = [], []
    for d in range(D):
        lo, hi = d * Lb, (d + 1) * Lb
        rows = C[lo:hi].tocsr()
        ints.append(rows[:, lo:hi].tocsr())
        if Hb:
            l0, r1 = max(lo - Hb, 0), min(hi + Hb, n_pad)
            parts = []
            if Hb > lo - l0:
                parts.append(sp.csr_matrix((Lb, Hb - (lo - l0))))
            parts.append(rows[:, l0:lo])
            parts.append(rows[:, hi:r1])
            if Hb > r1 - hi:
                parts.append(sp.csr_matrix((Lb, Hb - (r1 - hi))))
            bnds.append(sp.hstack(parts).tocsr())
    return ints, bnds


@dataclasses.dataclass(frozen=True)
class DistPencil:
    """Row-sharded pencil in the stacked view (see the module docstring).

    K_int, M_int: interior blocked-ELL parts, Dl L block rows, columns into
    the stacked X. K_bnd, M_bnd: boundary parts, columns into the stacked
    halo-extended buffer (None without a halo). Ui, Ub: the stacked interior
    and boundary union layouts of kernel="union" (Ub None without a halo).
    perm: the RCM permutation of the problem's rows (None if not
    reordered): vectors are in the permuted order, extract_vectors and
    inject_vectors map them to and from the problem's own order.
    link: this rank's HaloLink across processes (None in one process);
    close() releases its buffers.
    """

    D: int
    L: int  # block rows per shard
    H: int  # halo depth in block rows (each side)
    b: int
    n: int  # global logical dimension
    n_nodes: int
    proj: GradientProjector
    kernel: str = "ref"
    K_int: BSRMatrix | None = None
    K_bnd: BSRMatrix | None = None
    M_int: BSRMatrix | None = None
    M_bnd: BSRMatrix | None = None
    Ui: object | None = None
    Ub: object | None = None
    mass_tol: float = 1e-12
    mass_iters: int = 300
    proj_tol: float = 1e-10
    proj_iters: int = 150
    halo_impl: str = "ppermute"
    dcn_links: tuple = ()
    perm: np.ndarray | None = None
    link: HaloLink | None = dataclasses.field(default=None, compare=False)

    # --- shapes -----------------------------------------------------------
    @property
    def Lb(self) -> int:
        """Rows per shard."""
        return self.L * self.b

    @property
    def Hb(self) -> int:
        """Halo rows on either side of a shard."""
        return self.H * self.b

    @property
    def procs(self) -> int:
        return 1 if self.link is None else self.link.group.procs

    @property
    def Dl(self) -> int:
        """Shards this process holds."""
        return self.D // self.procs

    @property
    def d0(self) -> int:
        """The first of them."""
        return 0 if self.link is None else self.link.d0

    @property
    def global_rows(self) -> int:
        return self.D * self.Lb

    @property
    def n_padded(self) -> int:
        """Rows this process holds: the stacked view's."""
        return self.Dl * self.Lb

    def local(self, X):
        """This process's rows of a global (global_rows, ...) block."""
        return X[self.d0 * self.Lb:(self.d0 + self.Dl) * self.Lb]

    def close(self) -> None:
        """Release the exchange buffers across processes (a collective:
        every rank calls it)."""
        if self.link is not None:
            self.link.close()

    @property
    def _values(self) -> torch.Tensor:
        return self.Ui.vals if self.kernel == "union" else self.K_int.blocks

    @property
    def dtype(self) -> torch.dtype:
        return self._values.dtype

    @property
    def device(self) -> torch.device:
        return self._values.device

    # --- host-side helpers -------------------------------------------------
    def make_block(self, m: int, generator: torch.Generator | None = None):
        """Random start block in the stacked layout, zero past row n
        (default generator: seed 0 on the pencil's device): the global
        block's draws, this process's rows."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        X0 = torch.randn((self.global_rows, m), generator=generator,
                         dtype=self.dtype, device=generator.device)
        X0[self.n:] = 0.0
        return self.local(X0).to(self.device)

    def extract_vectors(self, X_stacked) -> np.ndarray:
        """Stacked rows (tensor or numpy; across processes this rank's,
        gathered from every rank) -> the problem's own ordering."""
        if self.link is not None:
            X_stacked = self.link.gather(torch.as_tensor(X_stacked))
        X = X_stacked.cpu().numpy() if torch.is_tensor(X_stacked) else (
            np.asarray(X_stacked))
        vecs = X[: self.n]
        if self.perm is not None:
            out = np.empty_like(vecs)
            out[self.perm] = vecs
            vecs = out
        return vecs

    def inject_vectors(self, X_orig) -> torch.Tensor:
        """Inverse of extract_vectors: the problem's ordering -> stacked
        rows (zero padded), on the pencil's device."""
        X = np.asarray(X_orig)
        if self.perm is not None:
            X = X[self.perm]
        X = np.ascontiguousarray(X[: self.n])
        out = torch.zeros((self.global_rows,) + X.shape[1:], dtype=self.dtype)
        out[: self.n] = torch.from_numpy(X).to(dtype=self.dtype)
        return self.local(out).to(self.device)

    # --- reductions: per-shard partials, summed over the shards -------------
    def weigh(self, x: torch.Tensor) -> torch.Tensor:
        return x  # block-row sharding has no replicated rows

    def _sum_shards(self, parts) -> torch.Tensor:
        """The Dl per-shard partials of this process (one call a shard, the
        same call whatever the process count) -> their sum over all D
        shards, in shard order: gathered from every rank first."""
        P = torch.stack(parts)
        if self.link is not None:
            P = self.link.gather(P)
        return P.sum(dim=0)

    def _shards(self, A: torch.Tensor):
        return A.reshape(self.Dl, self.Lb, *A.shape[1:])

    def dot_mm(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """A^T B: one product a shard, summed over the shards (a batched
        product of the shards runs on few thread blocks on the card,
        dist/stencil_dist.py DistStencilPencil3D.dot_mm)."""
        Av = A.reshape(self.Dl, self.Lb, -1)
        Bv = B.reshape(self.Dl, self.Lb, -1)
        return self._sum_shards([Av[j].T @ Bv[j] for j in range(self.Dl)])

    def dot_cols(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        P = self._shards(A * B)
        return self._sum_shards([P[j].sum(dim=0) for j in range(self.Dl)])

    def dot_vv(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.dot_cols(x, y)

    def dot_basis(self, V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(k,) <- V @ w over the rows, V (k, rows) a basis held by rows,
        w (rows,): one product a shard, summed over the shards."""
        Lb = self.Lb
        return self._sum_shards([V[:, j * Lb:(j + 1) * Lb] @ w[j * Lb:
                                                               (j + 1) * Lb]
                                 for j in range(self.Dl)])

    def col_norms(self, A: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.dot_cols(A, A), min=0.0))

    # --- halo exchange ---------------------------------------------------------
    def _exchange(self, X: torch.Tensor, own: bool, pad_rows: int):
        """Every local shard's halo section through the configured
        transport (see kernels/halo.py for the layout): per shard [own Lb if
        own | left Hb | right Hb | pad_rows zeros], stacked."""
        Hb = self.Hb
        if Hb and self.H <= self.L:
            if self.halo_impl == "rdma":
                return _halo.ring_shift(X.contiguous(), self.D, Hb, own,
                                        pad_rows, self.link)
            if self.dcn_links and self.link is None:
                return self._exchange_dcn(X, own, pad_rows)
            return _halo.ppermute(X, self.D, Hb, own, pad_rows, self.link)
        # H > L: the gather window; H = 0: no halo
        return _halo.assemble(X, self.Dl, *self._window(X), own, pad_rows)

    def _window(self, X: torch.Tensor, gather: bool = False):
        """(Dl, Hb, m) left and right halos of the local shards through the
        gather window (one process: slices where the halo is shallow and
        gather is False); across processes on the all-gathered X."""
        if self.link is None:
            return _halo.window(X, self.D, self.Hb, gather=gather)
        sl = slice(self.d0, self.d0 + self.Dl)
        left, right = _halo.window(self.link.gather(X), self.D, self.Hb,
                                   gather=True)
        return left[sl], right[sl]

    def _exchange_dcn(self, X, own, pad_rows):
        """The reference's DCN-first schedule in one process: the copies
        over links that cross hosts (positions p of link (p, p + 1) in
        dcn_links) first, then the others; each part is zero where the
        other copies, so their sum is the plain transport's result. Across
        processes the link's transports post their host-crossing sides
        first themselves."""
        left, right = self._window(X)
        dcn = set(self.dcn_links)
        shape = (self.Dl, 1, 1)
        shards = range(self.d0, self.d0 + self.Dl)
        # shard d's left halo comes over link d - 1, its right over link d
        lmask = torch.tensor([d - 1 in dcn for d in shards],
                             device=X.device).reshape(shape)
        rmask = torch.tensor([d in dcn for d in shards],
                             device=X.device).reshape(shape)
        zero = X.new_zeros(())
        left_d, right_d = (torch.where(lmask, left, zero),
                           torch.where(rmask, right, zero))
        left_i, right_i = (torch.where(~lmask, left, zero),
                           torch.where(~rmask, right, zero))
        return _halo.assemble(X, self.Dl, left_d + left_i, right_d + right_i,
                              own, pad_rows)

    def exchange_halos(self, X: torch.Tensor) -> torch.Tensor:
        """Stacked X (Dl Lb, m) -> the stacked halo-extended buffers, per
        shard [own Lb | left Hb | right Hb | zero b] rows (across processes
        a copy of the registered buffer, which the next exchange
        overwrites)."""
        vec = X.dim() == 1
        out = self._exchange(X[:, None] if vec else X, True, self.b)
        if self.link is not None:
            out = out.clone()
        return out[:, 0] if vec else out

    def exchange_halos_reference(self, X: torch.Tensor) -> torch.Tensor:
        """Oracle exchange through the gather window, whatever the depth and
        transport."""
        vec = X.dim() == 1
        Xl = X[:, None] if vec else X
        out = _halo.assemble(Xl, self.Dl, *self._window(Xl, gather=True),
                             True, self.b)
        return out[:, 0] if vec else out

    def halo_checksum(self, X: torch.Tensor) -> torch.Tensor:
        """Max |configured exchange - gather oracle| (a 0-d tensor)."""
        a = self.exchange_halos(X)
        return (a - self.exchange_halos_reference(X)).abs().max()

    # --- operator applies ------------------------------------------------------
    def _bsr(self, A: BSRMatrix, X: torch.Tensor) -> torch.Tensor:
        """A @ X for a 2-D X: the blocked-ELL kernels ("pallas"; the SpMV
        for a one-column block) or the plain apply ("ref")."""
        if self.kernel == "pallas":
            from maxwell_tpu_torch.kernels.bsr_spmm import (
                bsr_matmat,
                bsr_matvec,
            )

            X = X.contiguous()
            if X.shape[1] == 1:
                return bsr_matvec(A, X[:, 0])[:, None]
            return bsr_matmat(A, X)
        return bsr_matmat_ref(A, X)

    def _local_mm(self, A_int, A_bnd, X):
        """Interior product on the stacked X, then the boundary product on
        the halo-extended buffer (the reference's overlap structure; on one
        device the two run in stream order)."""
        vec = X.dim() == 1
        Xl = (X[:, None] if vec else X).contiguous()
        Y = self._bsr(A_int, Xl)
        if A_bnd is not None:
            Y = Y + self._bsr(A_bnd, self._exchange(Xl, True, self.b))
        return Y[:, 0] if vec else Y

    def _union_local_mm(self, X, streams: str):
        """Union apply of the requested streams ("a" K, "b" M, "ab" both):
        one halo section serves both streams. halo_impl="rdma_overlap": the
        interior products and the halo copy in one launch (K5)."""
        from maxwell_tpu_torch.kernels.spmm import bellunion_matmat

        vec = X.dim() == 1
        Xl = (X[:, None] if vec else X).contiguous()
        if (self.halo_impl == "rdma_overlap" and self.Ub is not None
                and self.H <= self.L):
            *Ys, Xh = _halo.union_interior_overlap(
                self.Ui, Xl, self.D, self.Hb, streams, self.link)
        else:
            Ys = [bellunion_matmat(self.Ui, Xl, s) for s in streams]
            Xh = None
        if self.Ub is not None:
            if Xh is None:
                Xh = self._exchange(Xl, False, 0)
            Ys = [y + bellunion_matmat(self.Ub, Xh, s)
                  for y, s in zip(Ys, streams)]
        outs = tuple(y[:, 0] if vec else y for y in Ys)
        return outs[0] if len(outs) == 1 else outs

    def K_mm(self, X: torch.Tensor) -> torch.Tensor:
        if self.kernel == "union":
            return self._union_local_mm(X, "a")
        return self._local_mm(self.K_int, self.K_bnd, X)

    def M_mm(self, X: torch.Tensor) -> torch.Tensor:
        if self.kernel == "union":
            return self._union_local_mm(X, "b")
        return self._local_mm(self.M_int, self.M_bnd, X)

    def KM_mm(self, X: torch.Tensor):
        """(K @ X, M @ X); kernel="union" shares one halo section between
        the two streams."""
        if self.kernel == "union":
            return self._union_local_mm(X, "ab")
        return self.K_mm(X), self.M_mm(X)

    def Minv_mm(self, X: torch.Tensor) -> torch.Tensor:
        return cg(self.M_mm, X, tol=self.mass_tol, maxiter=self.mass_iters,
                  dot=self.dot_cols)

    def project(self, X: torch.Tensor) -> torch.Tensor:
        """M-orthogonal projection off the gradient nullspace (CG on the
        nodal system, as the reference's distributed projector)."""
        return self.proj.project(self.M_mm, X, tol=self.proj_tol,
                                 maxiter=self.proj_iters)


def _stacked_bsr(blocks, cols, dtype, device) -> BSRMatrix:
    n = blocks.shape[0] * blocks.shape[2]
    return BSRMatrix._from_numpy(blocks, cols, n, None, None, 0, dtype,
                                 device, True)


def _local_shards(D: int, group) -> tuple[int, int]:
    """(Dl, d0): the shards a process holds, and the first of them."""
    if group is None:
        return D, 0
    if D % group.procs:
        raise ValueError(f"{D} shards do not divide over {group.procs} "
                         "processes")
    Dl = D // group.procs
    return Dl, group.rank * Dl


def _projector(G, D: int, Lb: int, dtype, device, link):
    """The gradient projector of a process's rows [d0 Lb, (d0 + Dl) Lb):
    every edge of G either way; across processes G^T gathers the ranks'
    rows through the link first (solvers/deflation.py), so it is the one
    process's bit for bit."""
    if link is None:
        return GradientProjector.from_gradient(G, D * Lb, dtype=dtype,
                                               device=device)
    return GradientProjector.from_gradient(
        G, D * Lb, dtype=dtype, device=device, gather=link.gather,
        rows=(link.d0 * Lb, (link.d0 + link.Dl) * Lb))


def _link(group, D: int, Lb: int, Hb: int) -> HaloLink | None:
    return None if group is None else HaloLink(group, D, Lb, Hb)


def partition_problem(
    problem,
    n_shards: int,
    block: int | None = None,
    kernel: str = "ref",
    dtype: torch.dtype = torch.float32,
    reorder: bool = True,
    halo_impl: str = "ppermute",
    mesh=None,
    dcn_links: tuple | None = None,
    device: str | torch.device | None = None,
) -> DistPencil:
    """Host-side partitioner: problem (RectCavity2D / BrickCavity3D) -> a
    row-sharded DistPencil on the mesh's device (else `device`, default
    the card). On a mesh over P processes every rank runs the same host
    partition and keeps its own shards [rank D / P, (rank + 1) D / P).

    reorder=True applies RCM so halos are shallow; the permutation is kept
    on the pencil (`perm`). dcn_links: positions p whose link (p, p + 1)
    crosses hosts; None takes them from the mesh's mesh_topology_report,
    as the reference does (a mesh on one host has none), and a tuple
    given here is a test seam, as in the reference.
    """
    if kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    if halo_impl not in _HALO_IMPLS:
        raise ValueError(f"unknown halo_impl {halo_impl!r}")
    group = None
    if mesh is not None:
        if mesh.D != n_shards:
            raise ValueError(f"mesh has {mesh.D} shards, asked for {n_shards}")
        device = mesh.device
        group = mesh.group
        if dcn_links is None:
            from maxwell_tpu_torch.dist.mesh import mesh_topology_report

            dcn_links = tuple(
                p for p in mesh_topology_report(mesh)["dcn_link_positions"]
                if p < n_shards - 1)
    device = torch.device("cuda" if device is None else device)
    dcn_links = tuple(dcn_links or ())
    if block is None:
        block = 8 if kernel in ("pallas", "union") else 4
    perm = None
    if reorder:
        from maxwell_tpu_torch.sparse.reorder import PermutedProblem

        problem = PermutedProblem(problem)
        perm = problem.perm
    if kernel == "union":
        return _partition_union(problem, n_shards, block, dtype, halo_impl,
                                dcn_links, device, perm, group)
    D, b = n_shards, block
    row_tile = max(128 // b, 1)
    K, M = (
        BSRMatrix.from_csr(A, block=b, dtype=torch.float64, device="cpu",
                           row_align=D * row_tile, kernel_metadata=False)
        for A in (problem.K, problem.M)
    )
    K_blocks_np, M_blocks_np = K.blocks.numpy(), M.blocks.numpy()
    K_cols_np, M_cols_np = K.cols.numpy(), M.cols.numpy()
    nbr = K.n_brows
    L = nbr // D

    # halo depth: max distance of any REAL (nonzero) block from its shard
    H = 0
    nz_K = np.abs(K_blocks_np).max(axis=(2, 3)) > 0  # (nbr, S)
    nz_M = np.abs(M_blocks_np).max(axis=(2, 3)) > 0
    for d in range(D):
        lo, hi = d * L, (d + 1) * L
        for cols_np, nz in ((K_cols_np, nz_K), (M_cols_np, nz_M)):
            cs = cols_np[lo:hi][nz[lo:hi]]
            if cs.size:
                H = max(H, int(max(lo - cs.min(), cs.max() - (hi - 1))))
    H = max(H, 0)

    # remap columns to the local layout [own L | left H | right H | zero 1]
    def remap(cols_np, nz):
        out = np.full_like(cols_np, L + 2 * H)  # default: zero slot
        for d in range(D):
            lo, hi = d * L, (d + 1) * L
            c = cols_np[lo:hi]
            m_ = nz[lo:hi]
            local = np.full_like(c, L + 2 * H)
            own = (c >= lo) & (c < hi)
            local[own & m_] = (c - lo)[own & m_]
            lft = (c >= lo - H) & (c < lo)
            local[lft & m_] = (L + (c - (lo - H)))[lft & m_]
            rgt = (c >= hi) & (c < hi + H)
            local[rgt & m_] = (L + H + (c - hi))[rgt & m_]
            if (m_ & ~(own | lft | rgt)).any():
                raise AssertionError("halo depth miscomputed")
            out[lo:hi] = local
        return out

    # split interior (own-row columns) from boundary (halo columns), then
    # point the columns at the stacked buffers: interior into the stacked X
    # (a padding slot, zero valued, reads the shard's first row), boundary
    # into the stacked halo-extended buffer (L + 2H + 1 block rows a shard);
    # a process keeps its own shards' block rows, its columns counted from
    # its first shard
    Dl, d0 = _local_shards(D, group)
    shard = np.repeat(np.arange(D), L)[:, None] - d0
    mine = slice(d0 * L, (d0 + Dl) * L)

    def split(blocks_np, cols_np, nz):
        cols_local = remap(cols_np, nz)
        nrows = cols_local.shape[0]
        int_mask = (cols_local < L) & nz
        bnd_mask = (cols_local >= L) & (cols_local < L + 2 * H) & nz

        def pack(mask, pad_col):
            counts = mask.sum(axis=1)
            Sm = max(int(counts.max()) if nrows else 1, 1)
            bi = np.zeros((nrows, Sm, b, b), dtype=blocks_np.dtype)
            ci = np.full((nrows, Sm), pad_col, dtype=np.int32)
            r_idx, s_idx = np.nonzero(mask)
            first = np.zeros(nrows + 1, dtype=np.int64)
            np.cumsum(counts, out=first[1:])
            pos = np.arange(len(r_idx)) - first[r_idx]
            ci[r_idx, pos] = cols_local[r_idx, s_idx]
            bi[r_idx, pos] = blocks_np[r_idx, s_idx]
            return bi, ci

        bi, ci = pack(int_mask, L)
        ci = np.where(ci < L, ci, 0) + shard * L
        A_int = _stacked_bsr(bi[mine], ci[mine], dtype, device)
        A_bnd = None
        if H:
            bb, cb = pack(bnd_mask, L + 2 * H)
            cb = cb + shard * (L + 2 * H + 1)
            A_bnd = _stacked_bsr(bb[mine], cb[mine], dtype, device)
        return A_int, A_bnd

    K_int, K_bnd = split(K_blocks_np, K_cols_np, nz_K)
    M_int, M_bnd = split(M_blocks_np, M_cols_np, nz_M)
    link = _link(group, D, L * b, H * b)
    proj = _projector(problem.G, D, L * b, dtype, device, link)
    return DistPencil(
        D=D, L=L, H=H, b=b, n=problem.K.shape[0], n_nodes=proj.n_nodes,
        proj=proj, kernel=kernel, K_int=K_int, K_bnd=K_bnd, M_int=M_int,
        M_bnd=M_bnd, halo_impl=halo_impl, dcn_links=dcn_links, perm=perm,
        link=link,
    )


def _stack_union(us, col_rows: int):
    """One layout from D per-shard union layouts of one chunk count NC:
    shard d's chunks at d NC (its tiles' live ends, tile_end, moved with
    them), its tiles at d T, its columns moved by d col_rows (the stacked
    buffer the layout reads), its live sub-blocks after shard d - 1's."""
    from maxwell_tpu_torch.sparse.bellunion import (
        BELLUnion,
        LiveBlocks,
        _tile_ptr,
    )

    u0 = us[0]
    D = len(us)
    cat = lambda f: torch.cat([getattr(u, f) for u in us])
    tile_of = torch.cat([u.tile_of + d * u0.n_tiles for d, u in enumerate(us)])
    return BELLUnion(
        vals=cat("vals"),
        vals_b=cat("vals_b"),
        ucols=torch.cat([u.ucols + d * (col_rows // u0.b)
                         for d, u in enumerate(us)]),
        tile_of=tile_of,
        first=cat("first"),
        tile_ptr=torch.from_numpy(
            _tile_ptr(tile_of.cpu().numpy(), D * u0.n_tiles)
        ).to(u0.tile_ptr.device),
        tile_end=torch.cat([
            (u.tile_ptr[1:] if u.tile_end is None else u.tile_end)
            + d * u.n_chunks for d, u in enumerate(us)]),
        n=D * u0.n_padded,
        n_tiles=D * u0.n_tiles,
        b=u0.b,
        cl=u0.cl,
        n_cols=D * col_rows,
        pack=u0.pack,
        live=LiveBlocks.stack([u.live for u in us], ("vals", "vals_b")),
    )


def _partition_union(problem, n_shards, block, dtype, halo_impl, dcn_links,
                     device, perm, group=None):
    """kernel="union" partitioner (maxwell_tpu/dist/partition.py:724): per
    shard, a square interior union layout and a rectangular boundary one
    (columns = the [left | right] halo section), both carrying K and M as
    two value streams on one union pattern; chunk counts padded to the
    per-shard maximum over all D shards (rounded up to 8), then this
    process's shards stacked (the others' are built on the host only for
    their chunk counts)."""
    from maxwell_tpu_torch.sparse.bellunion import BELLUnion

    if dtype != torch.float32:
        raise ValueError("kernel='union' is the f32 path (the union kernels)")
    D, b = n_shards, block
    Kc = sp.csr_matrix(problem.K)
    Mc = sp.csr_matrix(problem.M)
    n = Kc.shape[0]
    n_pad = _round_up(n, D * 128)
    Lb = n_pad // D
    L = Lb // b
    H = max(
        _halo_depth_csr(Kc, n_pad, L, b), _halo_depth_csr(Mc, n_pad, L, b)
    )
    Hb = H * b

    Ki, Kb = _shard_int_bnd_csr(Kc, D, Lb, Hb, n_pad)
    Mi, Mb = _shard_int_bnd_csr(Mc, D, Lb, Hb, n_pad)

    Dl, d0 = _local_shards(D, group)

    def build(Ks, Ms, ncols, cl, pack):
        us = [
            BELLUnion.from_csr(
                Ks[d], block=b, dtype=dtype, B=Ms[d], ncols=ncols,
                chunk_lanes=cl, pack=pack,
                device=device if d0 <= d < d0 + Dl else "cpu",
            )
            for d in range(D)
        ]
        NC = _round_up(max(u.n_chunks for u in us), 8)
        return _stack_union([u.pad_chunks(NC) for u in us[d0:d0 + Dl]],
                            ncols)

    # the reference's layout choice: cl 1024 with pack 2 where it fits
    u_cl = min(1024, max(128, _round_up(Lb, 128)))
    u_pack = 2 if (u_cl // b) % 2 == 0 else 1
    Ui = build(Ki, Mi, Lb, u_cl, u_pack)
    Ub = None
    if Hb:
        ub_cl = min(1024, max(128, _round_up(2 * Hb, 128)))
        ub_pack = 2 if (ub_cl // b) % 2 == 0 else 1
        Ub = build(Kb, Mb, 2 * Hb, ub_cl, ub_pack)

    link = _link(group, D, Lb, Hb)
    proj = _projector(problem.G, D, Lb, dtype, device, link)
    return DistPencil(
        D=D, L=L, H=H, b=b, n=n, n_nodes=proj.n_nodes, proj=proj,
        kernel="union", Ui=Ui, Ub=Ub, halo_impl=halo_impl,
        dcn_links=dcn_links, perm=perm, link=link,
    )
