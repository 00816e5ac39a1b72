"""Slab-sharded matrix-free 3D pencil (maxwell_tpu/dist/stencil_dist.py),
in the stacked view of dist/partition.py: all D slabs on one device, or
D / P consecutive slabs on each of P processes (a mesh over P processes,
dist/procs.py; rank r holds slabs [r Dl, (r + 1) Dl), Dl = D / P).

Decomposition: the x-axis cell range splits into D slabs of `cells` cells.
Slab d holds its edge fields on local grids

    Ex (cells,   ny+1, nz+1)   x-edges are cell-centred in x: fully owned
    Ey (cells+1, ny,   nz+1)   y/z-edges live on x-planes; the interface
    Ez (cells+1, ny+1, nz)     plane is replicated with the right neighbour

and its nodes on (cells+1, ny+1, nz+1). A vector is the stacked
(Dl n_loc_pad, m) tensor of a process's slabs: local slab j owns rows
[j n_loc_pad, (j + 1) n_loc_pad), [Ex | Ey | Ez | pad] each row-major.
Reductions weigh the replicated interface plane by zero (`w_dot`, so every
edge counts once), take the per-slab partial sums and add the D partials
in slab order: the psum. Across processes each rank takes its own slabs'
partials by the same calls over its Dl slabs, the D partials of all ranks
are gathered (HaloLink.gather) and added by the same sum. A ppermute pair
of the reference becomes a slice of the neighbouring slab's rows; across a
rank boundary the link's transport (kernels/halo.py HaloLink): the chain
ends get zero planes.

P processes against one: the applies, the ghost planes, the interface sums
and the row reductions are the same per-slab operations in the same order,
so on the CPU they agree bit for bit. A batched product over the slab axis
(the y/z transforms of the fast nodal solve and the spectral solve) is one
product whose shape holds the slab count, which picks its blocking, and
`dot_basis` is one product over the stacked rows in one process: these
agree to rounding (tests/test_torch_dist_stencil_procs.py states the
bounds). On the card any batched product or reduction may choose its
kernel by the batch count.

Applies:
  vacuum PEC (`taps`): the gather-form tap apply on ghost-extended slabs.
      Each slab's grids get one ghost x-plane per component and side (the
      left neighbour's Ex[-1], Ey[-2], Ez[-2]; the right neighbour's Ex[0],
      Ey[1], Ez[1]), so every owned output row sees its whole
      neighbourhood. An extended slab is itself a brick of (cells + 2, ny,
      nz) cells: Ex (c+2, ny+1, nz+1), Ey and Ez with c+3 planes. So on a
      CUDA device at f32 the apply runs the tap kernel K4
      (kernels/stencil_taps.py) on each slab's extended block, with the
      extended mask `ext_mask` (the slab's mask on its own planes, the
      copied plane's mask on a ghost plane, zero at the chain ends), one
      launch per slab and column pass, and keeps the owned output planes
      (Ex 1..c, Ey/Ez 1..c+1). Across processes on the card the rank's
      extended block is a registered buffer of its link: each neighbour
      pushes its three edge planes straight into the ghost slots (peer
      copies between the link's two fences; from a neighbour on another
      host the link's host-staged route lands them there), and K4 reads
      the block where it lies; on the CPU the planes cross over gloo. Every CPU apply and
      every f64 apply runs
      the plain version, torch slices in tap order as the reference's jnp:
      a rule on device and dtype, not a fallback; whatever the kernel
      refuses raises.
  materials: the element apply (one panel gather, a (12k, 12) contraction,
      scatter-adds) with the interface partial sums completed across slabs.
  double word (`KM_mm_dw`): the tap apply on ghost-extended grids in
      double-word f32 arithmetic (utils/twofloat), both words exchanged.

The gradient projector runs on slab node vectors with the same interface
sums and ownership weights; vacuum pencils solve the nodal system exactly
by tensor eigentransforms whose x contraction is the fixed-order sum of
the slabs' partials (`_fast_nodal_solve`), loaded ones by CG.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from maxwell_tpu_torch.kernels.halo import HaloLink
from maxwell_tpu_torch.kernels.stencil_taps import (
    component_shapes,
    stencil_taps,
)
from maxwell_tpu_torch.solvers.cg import cg
from maxwell_tpu_torch.solvers.spectral import (
    tr_x_local,
    tr_x_parts,
    tr_yz,
    x_rows,
)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class DistStencilPencil3D:
    """Slab-sharded matrix-free pencil in the stacked view (see the module
    docstring). Tensors live on the pencil's device (the mask's) and hold
    this process's Dl slabs; link: its HaloLink across processes (None in
    one process), close() releases its buffers."""

    mask: torch.Tensor  # (Dl n_loc_pad,) PEC mask per local edge
    w_dot: torch.Tensor  # (Dl n_loc_pad,) ownership weight (iface plane 0)
    Ke: torch.Tensor  # (12, 12)
    Me: torch.Tensor
    node_mask: torch.Tensor  # (Dl nn_loc,) interior-node mask
    node_w: torch.Tensor  # (Dl nn_loc,) node ownership weight
    # optional per-cell materials, slab-stacked: (Dl cells, ny, nz)
    inv_mu: torch.Tensor | None
    eps: torch.Tensor | None
    ax: float
    by: float
    cz: float
    nx: int
    ny: int
    nz: int
    cells: int  # slab width (cells per slab)
    D: int  # slabs of the whole problem
    n_loc: int  # local edge count (unpadded)
    n_loc_pad: int
    nn_loc: int  # local node count
    mass_tol: float = 1e-12
    mass_iters: int = 300
    proj_tol: float = 1e-10
    proj_iters: int = 150
    # exact nodal Poisson eigentransforms (vacuum only): _fast_nodal_solve
    fpVx_full: torch.Tensor | None = None  # (nx+1, nx-1), zero boundary rows
    fpVy: torch.Tensor | None = None  # (ny-1, ny-1)
    fpVz: torch.Tensor | None = None
    fp_inv_lam: torch.Tensor | None = None  # (nx-1, ny-1, nz-1)
    # translation-invariant taps (vacuum PEC, problems/stencil3d
    # _derive_taps) and their f64-accurate (hi, lo) pairs (_derive_taps_dw)
    taps: tuple | None = None
    taps_dw: tuple | None = None
    # the K4 route's mask of each slab's ghost-extended block (Dl, n_ext)
    ext_mask: torch.Tensor | None = None
    link: HaloLink | None = dataclasses.field(default=None, compare=False)

    # --- shapes -------------------------------------------------------------
    @property
    def procs(self) -> int:
        return 1 if self.link is None else self.link.group.procs

    @property
    def Dl(self) -> int:
        """Slabs this process holds."""
        return self.D // self.procs

    @property
    def d0(self) -> int:
        """The first of them."""
        return 0 if self.link is None else self.link.d0

    @property
    def global_rows(self) -> int:
        return self.D * self.n_loc_pad

    @property
    def n_padded(self) -> int:
        """Rows this process holds: the stacked view's."""
        return self.Dl * self.n_loc_pad

    @property
    def n(self) -> int:
        """The stacked view's dimension: every stacked row of the D slabs
        (padding rows are zero by the mask); `n_full` is the problem's edge
        count."""
        return self.global_rows

    def local(self, X):
        """This process's rows of a global (global_rows, ...) block."""
        return X[self.d0 * self.n_loc_pad:(self.d0 + self.Dl)
                 * self.n_loc_pad]

    def close(self) -> None:
        """Release the exchange buffers across processes (a collective:
        every rank calls it)."""
        if self.link is not None:
            self.link.close()

    @property
    def n_full(self) -> int:
        nx, ny, nz = self.nx, self.ny, self.nz
        return (nx * (ny + 1) * (nz + 1) + (nx + 1) * ny * (nz + 1)
                + (nx + 1) * (ny + 1) * nz)

    @property
    def dtype(self) -> torch.dtype:
        return self.mask.dtype

    @property
    def device(self) -> torch.device:
        return self.mask.device

    @property
    def proj(self):
        """The gradient projector is the pencil's own `project` (not None,
        so Lanczos re-projects each new basis vector)."""
        return self

    @property
    def ext_shape(self):
        """The brick of a ghost-extended slab, (cells + 2, ny, nz)."""
        return (self.cells + 2, self.ny, self.nz)

    @property
    def n_ext(self) -> int:
        """Rows of a ghost-extended slab's flat block."""
        return sum(a * b * c for a, b, c in component_shapes(self.ext_shape))

    @property
    def _sizes(self):
        c, ny, nz = self.cells, self.ny, self.nz
        return (c * (ny + 1) * (nz + 1), (c + 1) * ny * (nz + 1),
                (c + 1) * (ny + 1) * nz)

    # --- reductions: per-slab partials, summed over the slabs ---------------
    def weigh(self, x):
        return self.w_dot * x if x.dim() == 1 else self.w_dot[:, None] * x

    def _sum_slabs(self, *parts):
        """Each of `parts` a (Dl, ...) tensor of this process's per-slab
        partials -> its sum over all D slabs, added in slab order by one
        sum over the slab axis. Across processes the partials of every
        rank are gathered first, all parts in one gather."""
        if self.link is None:
            sums = [P.sum(dim=0) for P in parts]
        else:
            flat = self.link.gather(torch.cat(
                [P.reshape(self.Dl, -1) for P in parts], dim=1)).sum(dim=0)
            sums = [g.view(P.shape[1:]) for g, P in zip(torch.split(
                flat, [P[0].numel() for P in parts]), parts)]
        return sums[0] if len(parts) == 1 else sums

    def _slab_sums(self, P):
        """P (Dl n_loc_pad, ...) -> the sum over the rows of all D slabs:
        per-slab sums, then the sum of the D partials."""
        return self._sum_slabs(P.reshape(self.Dl, self.n_loc_pad,
                                         *P.shape[1:]).sum(dim=1))

    def dot_mm(self, A, B):
        """Each slab's A^T (w B), the D partials added in slab order. One
        product a slab: a batched product of the D slabs gets one thread
        block a slab from cuBLAS (3.6 ms at 64^3 in 8 slabs on the H100,
        PERF.md §5)."""
        Av = A.reshape(self.Dl, self.n_loc_pad, -1)
        Bv = self.weigh(B).reshape(self.Dl, self.n_loc_pad, -1)
        parts = [Av[j].T @ Bv[j] for j in range(self.Dl)]
        if self.link is not None:
            parts = self.link.gather(torch.stack(parts))
        out = parts[0]
        for d in range(1, self.D):
            out = out + parts[d]
        return out

    def dot_cols(self, A, B):
        return self._slab_sums(A * self.weigh(B))

    def dot_vv(self, x, y):
        return self._slab_sums(x * self.weigh(y))

    def dot_basis(self, V, w):
        """(k,) <- V @ (w_dot w), V (k, rows) a basis held by rows. In one
        process one product over the stacked rows; across processes each
        slab's product, the D partials summed in slab order (so it differs
        from one process's in the last bits)."""
        if self.link is None:
            return V @ self.weigh(w)  # over the stacked rows: already global
        Vs = V.reshape(V.shape[0], self.Dl, self.n_loc_pad).transpose(0, 1)
        ws = self.weigh(w).reshape(self.Dl, self.n_loc_pad, 1)
        return self._sum_slabs(torch.bmm(Vs, ws)[..., 0])

    def col_norms(self, A):
        return torch.sqrt(torch.clamp(self.dot_cols(A, A), min=0.0))

    # --- grids ---------------------------------------------------------------
    def _to_grids(self, X):
        """(Dl n_loc_pad, m) -> the slabs' (Dl, X, Y, Z, m) component
        grids."""
        return self._grid_views(X.reshape(self.Dl, self.n_loc_pad, -1))

    def _grid_views(self, Xs):
        """The (Dl, X, Y, Z, m) component views of a (Dl, n_loc_pad, m)
        buffer (writing them writes the buffer)."""
        c, ny, nz = self.cells, self.ny, self.nz
        shapes = ((c, ny + 1, nz + 1), (c + 1, ny, nz + 1),
                  (c + 1, ny + 1, nz))
        views, start = [], 0
        for s, size in zip(shapes, self._sizes):
            views.append(Xs[:, start : start + size].unflatten(1, s))
            start += size
        return views

    def _from_grids(self, Ex, Ey, Ez):
        m = Ex.shape[-1]
        out = torch.cat([g.reshape(self.Dl, -1, m) for g in (Ex, Ey, Ez)],
                        dim=1)
        out = torch.nn.functional.pad(
            out, (0, 0, 0, self.n_loc_pad - self.n_loc))
        return out.reshape(self.n_padded, m)

    # --- interface partial-sum exchange --------------------------------------
    def _iface_sum(self, A):
        """A (Dl, c+1, ..., m) holds partial sums whose first and last
        planes are shared with the neighbours: add the neighbour's copy to
        both (the reference's ppermute pair), so both copies agree. Across
        processes one plane crosses each rank boundary each way
        (HaloLink.swap)."""
        out = A.clone()
        out[1:, 0] += A[:-1, -1]
        out[:-1, -1] += A[1:, 0]
        link = self.link
        if link is not None:
            left, right = link.swap(A[0, 0], A[-1, -1])
            if not link.first:
                out[0, 0] += left
            if not link.last:
                out[-1, -1] += right
        return out

    # --- gather-form tap apply on ghost-extended slabs -----------------------
    def _ext_views(self, blk):
        """(X, Y, Z, m) grid views of a flat block of shape ext_shape; blk
        (n_ext, m), or (D, n_ext, m) for (D, X, Y, Z, m) views."""
        views, start = [], 0
        for s in component_shapes(self.ext_shape):
            size = s[0] * s[1] * s[2]
            views.append(blk[..., start : start + size, :].unflatten(-2, s))
            start += size
        return views

    def _ext_block(self, X):
        """(Dl n_loc_pad, m) -> (Dl, n_ext, m): each slab's ghost-extended
        grids as one flat block of the brick ext_shape, written in one
        pass: the slab's own planes, then one ghost x-plane per component
        and side, what its neighbours send in the reference's two packed
        ppermutes (the left neighbour's Ex[-1], Ey[-2], Ez[-2], the right
        one's Ex[0], Ey[1], Ez[1]; zeros at the chain ends). Across a rank
        boundary the planes come over the link: on the card the block is
        the rank's registered buffer (valid until its next exchange of that
        width), its neighbours' edge planes pushed into its ghost slots by
        a neighbour on this host, and landed there by the host-staged route
        from one on another host; on the CPU they cross over gloo."""
        link, m, Dl = self.link, X.shape[1], self.Dl
        on_card = link is not None and X.device.type == "cuda"
        bufs = (link.buffers(self.n_ext, m, X.dtype) if on_card else None)
        blk = (bufs.out.view(Dl, self.n_ext, m) if on_card
               else X.new_empty((Dl, self.n_ext, m)))
        grids, views = self._to_grids(X), self._ext_views(blk)
        # what the first slab sends left and the last slab sends right
        sides = [(-1, 0) if k == 0 else (-2, 1) for k in range(3)]
        to_left = [G[0, right] for G, (_, right) in zip(grids, sides)]
        to_right = [G[-1, left] for G, (left, _) in zip(grids, sides)]
        flat = lambda ps: torch.cat([p.reshape(-1) for p in ps])

        def local():
            for G, E, (left, right) in zip(grids, views, sides):
                # Ey/Ez: the last local plane is the interface, shared
                E[:, 1:-1] = G
                E[1:, 0] = G[:-1, left]
                E[:-1, -1] = G[1:, right]

        if link is None:
            local()
            for E in views:
                E[0, 0] = 0.0
                E[-1, -1] = 0.0
        elif not on_card:
            local()
            left_in, right_in = link.swap(flat(to_left), flat(to_right))
            start = 0
            for E in views:
                size = E[0, 0].numel()
                E[0, 0] = left_in[start:start + size].view(E[0, 0].shape)
                E[-1, -1] = right_in[start:start + size].view(
                    E[-1, -1].shape)
                start += size
        else:
            link.count_push(sum(p.numel() for p in to_left)
                            * X.element_size())
            # the neighbours on this host, whose ghost slots this rank fills
            peers = {side: self._ext_views(
                link.peer(bufs, side).view(Dl, self.n_ext, m))
                for side, push in zip(("left", "right"), link.pushes())
                if push}
            with link.exchange():
                # the sides that cross hosts first (host-staged)
                pending = link.post(
                    {"left": flat(to_left), "right": flat(to_right)},
                    {"left": [E[0, 0] for E in views],
                     "right": [E[-1, -1] for E in views]})
                local()
                for k, E in enumerate(views):
                    if link.first:
                        E[0, 0] = 0.0
                    elif not link.crosses["left"]:
                        peers["left"][k][-1, -1].copy_(to_left[k])
                    if link.last:
                        E[-1, -1] = 0.0
                    elif not link.crosses["right"]:
                        peers["right"][k][0, 0].copy_(to_right[k])
                link.land(pending)
        return blk

    def _owned(self, Y):
        """(D, n_ext, m) outputs on the extended slabs -> the stacked owned
        rows: Ex planes 1..c, Ey and Ez planes 1..c+1 (extended indices),
        padding rows zero."""
        c, m = self.cells, Y.shape[2]
        out = Y.new_empty((self.Dl, self.n_loc_pad, m))
        out[:, self.n_loc :] = 0.0
        for k, (src, dst) in enumerate(zip(self._ext_views(Y),
                                           self._grid_views(out))):
            dst.copy_(src[:, 1 : c + 1 + (k > 0)])
        return out.reshape(self.n_padded, m)

    def _taps_apply_ext(self, X, want_K, want_M):
        """The K4 route: the tap kernel on each slab's ghost-extended block
        with the extended mask (kernels/stencil_taps.stencil_taps: the
        kernel on CUDA tensors, its plain version on CPU ones), then the
        owned planes. X (Dl n_loc_pad, m)."""
        blk = self._ext_block(X)
        # each slab's launch writes straight into its rows of one buffer
        bufs = tuple(torch.empty_like(blk) if want else None
                     for want in (want_K, want_M))
        for d in range(self.Dl):
            stencil_taps(blk[d], self.ext_mask[d], self.taps, self.ext_shape,
                         want_K, want_M,
                         out=tuple(None if b is None else b[d] for b in bufs))
        return tuple(None if b is None else self._owned(b) for b in bufs)

    def _taps_apply_plain(self, X, want_K, want_M):
        """The plain slab apply: shifted slices of the y/z-padded extended
        grids in tap order, as the reference's jnp (stencil_dist.py:251)."""
        Xl = X * self.mask[:, None]
        m = Xl.shape[1]
        grids = self._to_grids(Xl)
        P = [torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1))
             for g in self._ext_views(self._ext_block(Xl))]
        outK, outM = [], []
        for alpha in range(3):
            s_ = grids[alpha].shape[1:4]
            accK = Xl.new_zeros((self.Dl,) + tuple(s_) + (m,))
            accM = accK
            for beta, (dx, dy, dz), cK, cM in self.taps[alpha]:
                sl = P[beta][:, 1 + dx : 1 + dx + s_[0],
                             1 + dy : 1 + dy + s_[1],
                             1 + dz : 1 + dz + s_[2]]
                if want_K and cK != 0.0:
                    accK = accK + cK * sl
                if want_M and cM != 0.0:
                    accM = accM + cM * sl
            outK.append(accK)
            outM.append(accM)
        mk = self.mask[:, None]
        return (self._from_grids(*outK) * mk if want_K else None,
                self._from_grids(*outM) * mk if want_M else None)

    def _taps_apply_slab(self, X, want_K, want_M):
        """(YK or None, YM or None) of the tap stencil on the slabs. A CUDA
        f32 X goes through the tap kernel (K4) on the ghost-extended blocks;
        every CPU X and every f64 X through the plain version. The rule is
        the device and the dtype, as in the one-device pencil: nothing
        falls back, and whatever the kernel refuses raises."""
        vec = X.dim() == 1
        Xl = X[:, None] if vec else X
        if Xl.device.type == "cuda" and Xl.dtype == torch.float32:
            out = self._taps_apply_ext(Xl, want_K, want_M)
        else:
            out = self._taps_apply_plain(Xl, want_K, want_M)
        return tuple(None if Y is None else (Y[:, 0] if vec else Y)
                     for Y in out)

    def KM_mm_dw(self, Xh, Xl, want_K=True, want_M=True):
        """Double-word slab tap apply: the ghost-extended gather structure
        of the plain slab apply, the ghost planes carrying both words (the
        exact f32 pair keeps the apply ~1e-13 accurate across slab
        boundaries), accumulation by error-free transforms
        (utils/twofloat). Works in Xh's dtype (f32) whatever the pencil's.
        Returns ((YKh, YKl) or None, (YMh, YMl) or None)."""
        from maxwell_tpu_torch.utils import twofloat as tf

        if self.taps_dw is None:
            raise ValueError("KM_mm_dw needs the vacuum slab tap pencil")
        mk = self.mask.to(Xh.dtype)[:, None]
        Xh = Xh * mk
        Xl = Xl * mk  # mask is 0/1: exact on both words
        m = Xh.shape[1]
        gh = self._to_grids(Xh)
        pad = lambda g: torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1))
        # both words in one extended block, so in one exchange
        ext = self._ext_views(self._ext_block(torch.cat([Xh, Xl], dim=1)))
        Ph = [pad(g[..., :m]) for g in ext]
        Pl = [pad(g[..., m:]) for g in ext]
        outK, outM = [], []
        for alpha in range(3):
            s_ = gh[alpha].shape[1:4]
            z = Xh.new_zeros((self.Dl,) + tuple(s_) + (m,))
            aKh, aKl, aMh, aMl = z, z, z, z
            # coefficient pairs as 0-d device tensors: a Python float would
            # make two_prod split it in f64
            tab = torch.tensor(
                [(*cK, *cM) for _, _, cK, cM in self.taps_dw[alpha]],
                dtype=Xh.dtype).to(Xh.device)
            for t, (beta, (dx, dy, dz), cK, cM) in enumerate(
                    self.taps_dw[alpha]):
                w = (slice(None), slice(1 + dx, 1 + dx + s_[0]),
                     slice(1 + dy, 1 + dy + s_[1]),
                     slice(1 + dz, 1 + dz + s_[2]))
                sh, sl = Ph[beta][w], Pl[beta][w]
                if want_K and (cK[0] != 0.0 or cK[1] != 0.0):
                    th, tl = tf.dw_mul(sh, sl, tab[t, 0], tab[t, 1])
                    aKh, aKl = tf.dw_add(aKh, aKl, th, tl)
                if want_M and (cM[0] != 0.0 or cM[1] != 0.0):
                    th, tl = tf.dw_mul(sh, sl, tab[t, 2], tab[t, 3])
                    aMh, aMl = tf.dw_add(aMh, aMl, th, tl)
            outK.append((aKh, aKl))
            outM.append((aMh, aMl))

        def pack(pairs):
            return (self._from_grids(*(p[0] for p in pairs)) * mk,
                    self._from_grids(*(p[1] for p in pairs)) * mk)

        return (pack(outK) if want_K else None,
                pack(outM) if want_M else None)

    # --- element apply (materials) -------------------------------------------
    def _element_apply_multi(self, E, X, scales=None):
        """Stacked element apply ((12k, 12) E -> k outputs) with one panel
        gather and one interface exchange per output field. scales: per
        output the per-cell (Dl cells, ny, nz) material coefficients."""
        Xl = X * self.mask[:, None]
        c, ny, nz = self.cells, self.ny, self.nz
        k = E.shape[0] // 12
        if scales is None:
            scales = (None,) * k
        Ex, Ey, Ez = self._to_grids(Xl)
        panels = [
            Ex[:, :, 0:ny, 0:nz], Ex[:, :, 1 : ny + 1, 0:nz],
            Ex[:, :, 0:ny, 1 : nz + 1], Ex[:, :, 1 : ny + 1, 1 : nz + 1],
            Ey[:, 0:c, :, 0:nz], Ey[:, 1 : c + 1, :, 0:nz],
            Ey[:, 0:c, :, 1 : nz + 1], Ey[:, 1 : c + 1, :, 1 : nz + 1],
            Ez[:, 0:c, 0:ny, :], Ez[:, 1 : c + 1, 0:ny, :],
            Ez[:, 0:c, 1 : ny + 1, :], Ez[:, 1 : c + 1, 1 : ny + 1, :],
        ]
        G = torch.stack(panels)  # (12, Dl, c, ny, nz, m)
        Y = torch.einsum("ab,bdxyzm->adxyzm", E, G)
        outs = []
        for j in range(k):
            Yj = Y[12 * j : 12 * (j + 1)]
            if scales[j] is not None:
                Yj = Yj * scales[j].reshape(self.Dl, c, ny, nz)[None, ...,
                                                                None]
            Yx, Yy, Yz = (torch.zeros_like(g) for g in (Ex, Ey, Ez))
            Yx[:, :, 0:ny, 0:nz] += Yj[0]
            Yx[:, :, 1 : ny + 1, 0:nz] += Yj[1]
            Yx[:, :, 0:ny, 1 : nz + 1] += Yj[2]
            Yx[:, :, 1 : ny + 1, 1 : nz + 1] += Yj[3]
            Yy[:, 0:c, :, 0:nz] += Yj[4]
            Yy[:, 1 : c + 1, :, 0:nz] += Yj[5]
            Yy[:, 0:c, :, 1 : nz + 1] += Yj[6]
            Yy[:, 1 : c + 1, :, 1 : nz + 1] += Yj[7]
            Yz[:, 0:c, 0:ny, :] += Yj[8]
            Yz[:, 1 : c + 1, 0:ny, :] += Yj[9]
            Yz[:, 0:c, 1 : ny + 1, :] += Yj[10]
            Yz[:, 1 : c + 1, 1 : ny + 1, :] += Yj[11]
            # complete the interface partial sums
            Yy, Yz = self._iface_sum(Yy), self._iface_sum(Yz)
            outs.append(self._from_grids(Yx, Yy, Yz) * self.mask[:, None])
        return torch.stack(outs)

    def _element_apply(self, E, X, scale=None):
        vec = X.dim() == 1
        Xl = X[:, None] if vec else X
        out = self._element_apply_multi(E, Xl, scales=(scale,))[0]
        return out[:, 0] if vec else out

    def K_mm(self, X):
        if self.taps is not None:
            return self._taps_apply_slab(X, True, False)[0]
        return self._element_apply(self.Ke, X, scale=self.inv_mu)

    def M_mm(self, X):
        if self.taps is not None:
            return self._taps_apply_slab(X, False, True)[1]
        return self._element_apply(self.Me, X, scale=self.eps)

    def KM_mm(self, X):
        if self.taps is not None:
            # fused taps: one extended block, each shifted input read once
            return self._taps_apply_slab(X, True, True)
        vec = X.dim() == 1
        Xl = X[:, None] if vec else X
        Y2 = self._element_apply_multi(
            torch.cat([self.Ke, self.Me]), Xl, scales=(self.inv_mu, self.eps))
        if vec:
            return Y2[0][:, 0], Y2[1][:, 0]
        return Y2[0], Y2[1]

    def Minv_mm(self, X):
        return cg(self.M_mm, X, tol=self.mass_tol, maxiter=self.mass_iters,
                  dot=self.dot_cols)

    # --- gradient projector (slab node vectors) ------------------------------
    def _node_dot(self, x, y):
        w = self.node_w if x.dim() == 1 else self.node_w[:, None]
        P = x * w * y
        return self._sum_slabs(P.reshape(self.Dl, self.nn_loc,
                                         *P.shape[1:]).sum(dim=1))

    def _node_grid(self, phi):
        c, ny, nz = self.cells, self.ny, self.nz
        return phi.reshape(self.Dl, c + 1, ny + 1, nz + 1, phi.shape[1])

    def _g_mm(self, phi):
        """(D n_loc_pad, m) <- G phi for slab node vectors (D nn_loc, m):
        finite differences on the local node grids."""
        vec = phi.dim() == 1
        ph = phi[:, None] if vec else phi
        hx, hy, hz = self.ax / self.nx, self.by / self.ny, self.cz / self.nz
        P = self._node_grid(ph * self.node_mask[:, None])
        out = self._from_grids((P[:, 1:] - P[:, :-1]) / hx,
                               (P[:, :, 1:] - P[:, :, :-1]) / hy,
                               (P[:, :, :, 1:] - P[:, :, :, :-1]) / hz)
        return out[:, 0] if vec else out

    def _gt_mm(self, y):
        """(D nn_loc, m) <- G^T y with the interface partial sums completed.
        The scatter is ownership-weighted (w_dot), so G^T is the adjoint of
        G in the weighted inner product and the projector M-self-adjoint."""
        vec = y.dim() == 1
        yl = y[:, None] if vec else y
        hx, hy, hz = self.ax / self.nx, self.by / self.ny, self.cz / self.nz
        Ex, Ey, Ez = self._to_grids(yl * self.w_dot[:, None])
        pad = torch.nn.functional.pad
        Exp = pad(Ex, (0, 0, 0, 0, 0, 0, 1, 1))  # (Dl, c+2, ny+1, nz+1, m)
        Eyp = pad(Ey, (0, 0, 0, 0, 1, 1))
        Ezp = pad(Ez, (0, 0, 1, 1))
        acc = (Exp[:, :-1] - Exp[:, 1:]) / hx
        acc = acc + (Eyp[:, :, :-1] - Eyp[:, :, 1:]) / hy
        acc = acc + (Ezp[:, :, :, :-1] - Ezp[:, :, :, 1:]) / hz
        out = self._iface_sum(acc).reshape(self.Dl * self.nn_loc, -1)
        out = out * self.node_mask[:, None]
        return out[:, 0] if vec else out

    def _fast_nodal_solve(self, r):
        """Exact q = (G^T M G)^-1 r on the slab interior-node grids (vacuum):
        per-axis eigentransforms; each slab contracts its own x-planes
        (ownership-weighted) and the D partial mode grids are summed in
        slab order (the reference's psum), so the inverse transform back to
        each slab's planes is local and agrees on the interface copies."""
        ny, nz = self.ny, self.nz
        c, Dl = self.cells, self.Dl
        G = self._node_grid(r * self.node_w[:, None])[:, :, 1:ny, 1:nz]
        Vxl = x_rows(self.fpVx_full, c + 1, c, Dl, self.d0)  # (Dl, c+1, nx-1)
        Rt = self._sum_slabs(tr_x_parts(tr_yz(G, self.fpVy, self.fpVz), Vxl))
        Rt = Rt * self.fp_inv_lam[..., None]
        q = tr_yz(tr_x_local(Rt, Vxl), self.fpVy.T, self.fpVz.T)
        out = torch.nn.functional.pad(q, (0, 0, 1, 1, 1, 1))
        out = out.reshape(Dl * self.nn_loc, -1)
        return out * self.node_mask[:, None]

    def project(self, X):
        """M-orthogonal projection off the gradient nullspace, with the
        PEC mask applied."""
        vec = X.dim() == 1
        Xm = (X[:, None] if vec else X) * self.mask[:, None]
        nmask = self.node_mask[:, None]
        rhs = nmask * self._gt_mm(self.M_mm(Xm))
        if self.fpVx_full is not None:
            q = self._fast_nodal_solve(rhs)
        else:
            def L_mm(phi):
                return nmask * self._gt_mm(self.M_mm(self._g_mm(nmask * phi)))

            q = cg(L_mm, rhs, tol=self.proj_tol, maxiter=self.proj_iters,
                   dot=self._node_dot)
        out = Xm - self._g_mm(q) * self.mask[:, None]
        return out[:, 0] if vec else out

    # --- construction --------------------------------------------------------
    @staticmethod
    def build(
        a=1.0, b=1.0, c_len=1.0, nx=8, ny=8, nz=8, D=8,
        dtype: torch.dtype = torch.float32, block: int = 8,
        eps_r=None, mu_r=None, device: str | torch.device = "cuda",
        mesh=None,
    ) -> "DistStencilPencil3D":
        """The reference's build (stencil_dist.py:603), on `device` (the
        card unless the caller asks for the CPU), or on the mesh's device
        with its process count (dist/mesh.py; D slabs over mesh.procs
        processes): every rank runs the same host build and keeps its own
        slabs."""
        from maxwell_tpu_torch.problems.cavity3d import hex_element_matrices
        from maxwell_tpu_torch.problems.stencil3d import (
            _derive_taps,
            _derive_taps_dw,
            numpy_dtype,
        )
        from maxwell_tpu_torch.solvers.fast_poisson import _modes_1d

        if nx % D != 0:
            raise ValueError("nx must be divisible by the shard count")
        group = None
        if mesh is not None:
            if mesh.D != D:
                raise ValueError(f"mesh has {mesh.D} shards, asked for {D} "
                                 "slabs")
            device, group = mesh.device, mesh.group
        cells = nx // D
        hx, hy, hz = a / nx, b / ny, c_len / nz
        Ke, Me = hex_element_matrices(hx, hy, hz)
        sx = cells * (ny + 1) * (nz + 1)
        sy = (cells + 1) * ny * (nz + 1)
        sz = (cells + 1) * (ny + 1) * nz
        n_loc = sx + sy + sz
        n_loc_pad = _round_up(n_loc, block * max(128 // block, 1))
        nn_loc = (cells + 1) * (ny + 1) * (nz + 1)

        dt = numpy_dtype(dtype)
        mask = np.zeros((D, n_loc_pad), dtype=dt)
        w_dot = np.zeros((D, n_loc_pad), dtype=dt)
        node_mask = np.zeros((D, nn_loc), dtype=dt)
        node_w = np.zeros((D, nn_loc), dtype=dt)
        grid = lambda *n: np.meshgrid(*(np.arange(k) for k in n),
                                      indexing="ij")
        for d in range(D):
            x0 = d * cells  # global x-plane of local plane 0
            xi, xj, xk = grid(cells, ny + 1, nz + 1)
            keep = ((xj != 0) & (xj != ny) & (xk != 0) & (xk != nz))
            mask[d, :sx] = keep.reshape(-1)
            w_dot[d, :sx] = keep.reshape(-1)  # fully owned
            yi, yj, yk = grid(cells + 1, ny, nz + 1)
            gx = yi + x0
            keep = (gx != 0) & (gx != nx) & (yk != 0) & (yk != nz)
            mask[d, sx : sx + sy] = keep.reshape(-1)
            w_dot[d, sx : sx + sy] = (keep & (yi != cells)).reshape(-1)
            zi, zj, zk = grid(cells + 1, ny + 1, nz)
            gx = zi + x0
            keep = (gx != 0) & (gx != nx) & (zj != 0) & (zj != ny)
            mask[d, sx + sy : n_loc] = keep.reshape(-1)
            w_dot[d, sx + sy : n_loc] = (keep & (zi != cells)).reshape(-1)
            ni, nj, nk = grid(cells + 1, ny + 1, nz + 1)
            gx = ni + x0
            interior = ((gx > 0) & (gx < nx) & (nj > 0) & (nj < ny)
                        & (nk > 0) & (nk < nz))
            node_mask[d] = interior.reshape(-1)
            node_w[d] = (interior & (ni != cells)).reshape(-1)

        # across processes the whole problem's slabs are built on the host
        # and each process keeps its own on its device (_keep)
        home = device if group is None else "cpu"
        t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype,
                                      device=home)
        # per-cell materials: cells are disjoint across slabs, so the plain
        # (D cells, ny, nz) stacking is the slab layout
        inv_mu = None if mu_r is None else t(
            1.0 / np.asarray(mu_r)).reshape(D * cells, ny, nz)
        eps = None if eps_r is None else t(eps_r).reshape(D * cells, ny, nz)
        taps = taps_dw = None
        fp = dict.fromkeys(("fpVx_full", "fpVy", "fpVz", "fp_inv_lam"))
        if inv_mu is None and eps is None:
            # taps from the dtype-cast element matrices, so the tap and
            # element paths agree at the working dtype
            taps = _derive_taps(np.asarray(Ke, dt), np.asarray(Me, dt))
            taps_dw = _derive_taps_dw(Ke, Me)
            lx, Vx = _modes_1d(nx, a / nx)
            ly, Vy = _modes_1d(ny, b / ny)
            lz, Vz = _modes_1d(nz, c_len / nz)
            Vx_full = np.zeros((nx + 1, nx - 1))
            Vx_full[1:nx] = Vx
            fp = dict(
                fpVx_full=t(Vx_full), fpVy=t(Vy), fpVz=t(Vz),
                fp_inv_lam=t(1.0 / (lx[:, None, None] + ly[None, :, None]
                                    + lz[None, None, :])))
        p = DistStencilPencil3D(
            mask=t(mask.reshape(-1)), w_dot=t(w_dot.reshape(-1)),
            Ke=t(Ke), Me=t(Me), node_mask=t(node_mask.reshape(-1)),
            node_w=t(node_w.reshape(-1)), inv_mu=inv_mu, eps=eps,
            ax=a, by=b, cz=c_len, nx=nx, ny=ny, nz=nz, cells=cells, D=D,
            n_loc=n_loc, n_loc_pad=n_loc_pad, nn_loc=nn_loc, taps=taps,
            taps_dw=taps_dw, **fp,
        )
        if taps is not None:
            # the K4 route's extended mask: each ghost plane carries the
            # mask of the plane it copies, zero at the chain ends
            p = dataclasses.replace(p, ext_mask=p._ext_block(
                p.mask[:, None])[..., 0].contiguous())
        return p if group is None else p._keep(group, torch.device(device))

    def _keep(self, group, device) -> "DistStencilPencil3D":
        """This whole-problem pencil's slabs of the process `group` names,
        on `device`, with the link across processes."""
        if self.D % group.procs:
            raise ValueError(f"{self.D} slabs do not divide over "
                             f"{group.procs} processes")
        Dl = self.D // group.procs
        d0 = group.rank * Dl

        def mine(v, per_slab):
            if v is None:
                return None
            if per_slab:
                v = v.reshape(self.D, -1, *v.shape[1:])[d0:d0 + Dl]
                v = v.reshape(-1, *v.shape[2:])
            return v.to(device)

        per_slab = ("mask", "w_dot", "node_mask", "node_w", "inv_mu", "eps",
                    "ext_mask")
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)}
        fields.update({
            name: mine(v, name in per_slab) for name, v in fields.items()
            if torch.is_tensor(v)})
        link = HaloLink(group, self.D, self.n_loc_pad, 0)
        return DistStencilPencil3D(**{**fields, "link": link})

    # --- host-side layout maps -----------------------------------------------
    def _scatter_idx(self):
        """Device gather map of the global -> stacked layout (cached on the
        instance): stacked row r reads global row idx[r], or is padding
        where valid is 0. Built once by pushing an index vector through
        scatter_vector."""
        cached = self.__dict__.get("_scatter_idx_cache")
        if cached is None:
            marker = self.scatter_vector(
                np.arange(1, self.n_full + 1, dtype=np.float64))
            idx = np.asarray(marker, np.int64) - 1
            valid = idx >= 0
            cached = (torch.from_numpy(np.maximum(idx, 0)).to(self.device),
                      torch.from_numpy(valid).to(self.device, self.dtype))
            object.__setattr__(self, "_scatter_idx_cache", cached)
        return cached

    def make_block(self, m: int, generator: torch.Generator | None = None):
        """Random start block drawn in the global stencil layout (so the
        interface copies agree) and gathered into this process's stacked
        rows on the device (default generator: seed 0 on the pencil's
        device)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        xg = torch.randn((self.n_full, m), generator=generator,
                         dtype=self.dtype, device=generator.device)
        idx, valid = self._scatter_idx()
        return xg.to(self.device)[idx] * valid[:, None]

    def extract_vectors(self, X_stacked) -> np.ndarray:
        """Stacked rows (tensor or numpy; across processes this rank's,
        gathered from every rank) -> the global stencil layout."""
        if torch.is_tensor(X_stacked):
            X_stacked = X_stacked.detach().cpu().numpy()
        return self.gather_vector(np.asarray(X_stacked))

    def inject_vectors(self, X_orig) -> torch.Tensor:
        """Global stencil layout (n_full[, m]) -> this process's stacked
        rows on the pencil's device, by a device gather."""
        idx, valid = self._scatter_idx()
        if not torch.is_tensor(X_orig):
            X_orig = torch.from_numpy(np.array(X_orig))
        X = X_orig.to(self.device, self.dtype)
        vec = X.dim() == 1
        Xl = X[:, None] if vec else X
        out = Xl[idx] * valid[:, None]
        return out[:, 0] if vec else out

    def scatter_vector(self, x_full: np.ndarray) -> np.ndarray:
        """Global StencilPencil3D layout (n_full[, m]) -> this process's
        stacked rows (Dl n_loc_pad[, m]) with consistent interface copies
        (host)."""
        nx, ny, nz, c = self.nx, self.ny, self.nz, self.cells
        sxg = nx * (ny + 1) * (nz + 1)
        syg = (nx + 1) * ny * (nz + 1)
        x_full = np.asarray(x_full)
        m = x_full.shape[1] if x_full.ndim > 1 else 1
        xf = x_full.reshape(-1, m)
        Ex = xf[:sxg].reshape(nx, ny + 1, nz + 1, m)
        Ey = xf[sxg : sxg + syg].reshape(nx + 1, ny, nz + 1, m)
        Ez = xf[sxg + syg :].reshape(nx + 1, ny + 1, nz, m)
        out = np.zeros((self.Dl, self.n_loc_pad, m), dtype=xf.dtype)
        for j in range(self.Dl):
            x0 = (self.d0 + j) * c
            out[j, : self.n_loc] = np.concatenate([
                Ex[x0 : x0 + c].reshape(-1, m),
                Ey[x0 : x0 + c + 1].reshape(-1, m),
                Ez[x0 : x0 + c + 1].reshape(-1, m)])
        out = out.reshape(self.n_padded, m)
        return out[:, 0] if x_full.ndim == 1 else out

    def gather_vector(self, x_stacked: np.ndarray) -> np.ndarray:
        """Inverse of scatter_vector (host; across processes every rank's
        rows gathered first; the right slab's copy of an interface plane
        wins, as in the reference)."""
        nx, ny, nz, c = self.nx, self.ny, self.nz, self.cells
        xs = np.asarray(x_stacked)
        m = xs.shape[1] if xs.ndim > 1 else 1
        xs2 = xs.reshape(self.Dl, self.n_loc_pad, m)
        if self.link is not None:
            xs2 = self.link.group.all_gather(torch.from_numpy(
                np.ascontiguousarray(xs2))).reshape(
                    self.D, self.n_loc_pad, m).numpy()
        sx, sy, _ = self._sizes
        Ex = np.zeros((nx, ny + 1, nz + 1, m), dtype=xs.dtype)
        Ey = np.zeros((nx + 1, ny, nz + 1, m), dtype=xs.dtype)
        Ez = np.zeros((nx + 1, ny + 1, nz, m), dtype=xs.dtype)
        for d in range(self.D):
            x0 = d * c
            loc = xs2[d]
            Ex[x0 : x0 + c] = loc[:sx].reshape(c, ny + 1, nz + 1, m)
            Ey[x0 : x0 + c + 1] = loc[sx : sx + sy].reshape(
                c + 1, ny, nz + 1, m)
            Ez[x0 : x0 + c + 1] = loc[sx + sy : self.n_loc].reshape(
                c + 1, ny + 1, nz, m)
        out = np.concatenate(
            [Ex.reshape(-1, m), Ey.reshape(-1, m), Ez.reshape(-1, m)])
        return out[:, 0] if xs.ndim == 1 else out
