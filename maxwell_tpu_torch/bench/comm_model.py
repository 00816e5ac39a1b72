"""Communication volume model of the distributed LOBPCG iteration on the
slab-sharded stencil pencil: the port's counterpart of
maxwell_tpu/bench/comm_model.py.

`CommModel` keeps the reference's volume formulas and time model and gives
the same numbers for the same inputs (its bandwidth defaults are the
reference's link rates, parameters of the model, not rates of this port's
transport: pass measured ones). Per LOBPCG iteration of the slab pencil
(dist/stencil_dist.py, solvers/spectral.py):

1. ghost planes: one packed plane (Ex, Ey, Ez) a side per KM apply,
   `halo_bytes()` for a rank with two neighbours;
2. the projector's interface sums: `projector_permute_bytes()`;
3. the spectral solve's and the nodal solve's x contractions: replicated
   mode volumes, `spectral_psum_bytes(D)` and `projector_psum_bytes(D)`.

The reference checked its volumes against the collectives of its compiled
HLO (`collective_bytes_from_hlo`). Eager torch has no HLO; in its place the
transport counts what it moves (kernels/halo.py HaloLink: `bytes_pushed`
to the neighbours, `bytes_gathered` by the reductions' all-gathers), read
by `link_volumes`. This transport sums a reduction by gathering every
slab's partial to every rank (so P processes give one process's bits): a
spectral solve gathers D partials of the mode volume,
`spectral_gather_bytes(D)`, where a ring all-reduce moves
2 (D - 1) / D of one.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Per-iteration communication of the slab-sharded stencil LOBPCG at D
    slabs of `cells` x-cells each (maxwell_tpu/bench/comm_model.py
    CommModel: the same fields, formulas and numbers). One LOBPCG
    iteration issues one KM apply, one preconditioner solve and one
    projection; the Gram and Rayleigh-Ritz reductions are O((3m)^2) floats
    and left out, as in the reference."""

    ny: int
    nz: int
    cells: int  # x-cells per shard (weak scaling keeps this constant)
    m: int  # LOBPCG block width
    t_compute_iter_s: float  # measured one-device time per iteration
    bw_ici: float = 4.5e10  # B/s per neighbour link direction
    bw_dcn: float = 2.5e10  # B/s per host-crossing link
    overlap_halo: float = 1.0  # fraction of the halo time hidden

    def halo_bytes(self) -> int:
        """Ghost-plane bytes per KM tap apply: one packed plane (all three
        components) per side, two sides."""
        ny, nz = self.ny, self.nz
        a_face = (ny + 1) * (nz + 1) + ny * (nz + 1) + (ny + 1) * nz
        return int(2 * a_face * self.m * 4)

    def projector_permute_bytes(self) -> int:
        """Interface-sum bytes inside the nodal gradient projector: ~4
        nodal-plane pairs per application."""
        return int(4 * 2 * (self.ny + 1) * (self.nz + 1) * self.m * 4)

    def spectral_psum_bytes(self, D: int) -> int:
        """The replicated mode volume of the distributed spectral solve:
        the three component lattices nx(ny-1)(nz-1) + (nx-1)ny(nz-1) +
        (nx-1)(ny-1)nz, m columns, f32."""
        nx, ny, nz = self.cells * D, self.ny, self.nz
        n_modes = (
            nx * (ny - 1) * (nz - 1)
            + (nx - 1) * ny * (nz - 1)
            + (nx - 1) * (ny - 1) * nz
        )
        return int(n_modes * self.m * 4)

    def projector_psum_bytes(self, D: int) -> int:
        """The replicated interior-node mode volume of the projector's
        fast nodal solve, (nx-1)(ny-1)(nz-1)."""
        nx = self.cells * D
        return int((nx - 1) * (self.ny - 1) * (self.nz - 1) * self.m * 4)

    def spectral_gather_bytes(self, D: int) -> int:
        """What this transport gathers to each rank for one spectral
        solve: every slab's partial mode volume."""
        return D * self.spectral_psum_bytes(D)

    def projector_gather_bytes(self, D: int) -> int:
        """The same for the fast nodal solve of one projection."""
        return D * self.projector_psum_bytes(D)

    def t_iter(self, D: int, hosts: int = 1) -> dict:
        """Predicted per-iteration time decomposition at D shards."""
        if D == 1:
            return {
                "compute": self.t_compute_iter_s, "halo": 0.0,
                "allreduce": 0.0, "total": self.t_compute_iter_s,
            }
        link = self.bw_dcn if hosts > 1 else self.bw_ici
        t_halo = (
            self.halo_bytes() / link * (1.0 - self.overlap_halo)
            + self.projector_permute_bytes() / link
        )
        # ring all-reduce of the replicated mode volumes; weak scaling
        # grows the volume with D, and each link carries ~2*V*(D-1)/D
        V = self.spectral_psum_bytes(D) + self.projector_psum_bytes(D)
        t_ar = 2.0 * V * (D - 1) / D / link
        total = self.t_compute_iter_s + t_halo + t_ar
        return {
            "compute": self.t_compute_iter_s, "halo": t_halo,
            "allreduce": t_ar, "total": total,
        }

    def weak_efficiency(self, D: int, hosts: int = 1) -> float:
        """t(1 shard) / t(D shards) at constant per-shard work."""
        return self.t_compute_iter_s / self.t_iter(D, hosts)["total"]

    def report(self, sizes=(1, 2, 4, 8), hosts_of=None) -> list[dict]:
        """Predicted efficiency and the dominant communication term per
        shard count (hosts: hosts_of(D), else 1 up to 4 shards and D / 4
        above, as in the reference)."""
        rows = []
        for D in sizes:
            h = hosts_of(D) if hosts_of else (1 if D <= 4 else D // 4)
            t = self.t_iter(D, h)
            dom = max(("halo", "allreduce"), key=lambda k: t[k])
            rows.append({
                "devices": D,
                "hosts": h,
                "predicted_efficiency": self.t_compute_iter_s / t["total"],
                "t_iter_ms": t["total"] * 1e3,
                "comm_fraction": 1.0 - t["compute"] / t["total"],
                "dominant_comm": dom if t[dom] > 0 else "none",
            })
        return rows


def link_volumes(link) -> dict:
    """What a rank's HaloLink (kernels/halo.py) has moved so far: bytes
    pushed to its neighbours on its host and sent to those on another
    host (the links this model prices at bw_dcn), exchanges through the
    registered buffers, the reductions' all-gathers and the bytes they
    returned, and the host seconds in barriers, in the host-staged
    transfers and in gathers. Zeros in one process (no link)."""
    keys = ("bytes_pushed", "bytes_across_hosts", "exchanges", "gathers",
            "bytes_gathered", "wait_s", "host_s", "gather_s")
    return {k: getattr(link, k) if link is not None else 0 for k in keys}
