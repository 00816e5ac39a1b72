"""The shard mesh of a distributed pencil (maxwell_tpu/dist/mesh.py).

The reference builds a 1-D JAX device mesh, one device per shard, sorted
hosts-major by (process_index, id), and runs its solvers per shard under
shard_map. The port holds the D shards of a row-sharded pencil in a
stacked view (dist/partition.py): shard d owns rows [d Lb, (d + 1) Lb) of
every vector. One process holds all D on one device (procs 1), or P
processes (dist/procs.py) hold D / P consecutive shards each, on the cards
of one host or of H hosts, P / H ranks a host with hosts-major ranks. So a
mesh is D shards over P processes on H hosts, and its halo links are the D
- 1 neighbour pairs, of which the H - 1 between the last shard of one host
and the first of the next cross hosts.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D row shards over `procs` processes on `hosts` hosts; this process
    is `rank` and holds shards [rank D / procs, (rank + 1) D / procs) on
    `device`."""

    D: int
    device: torch.device
    procs: int = 1
    rank: int = 0
    group: object = dataclasses.field(default=None, compare=False)
    hosts: int = 1

    def shard_hosts(self) -> list[int]:
        """The host of each shard, in shard order."""
        per_rank, per_host = self.D // self.procs, self.procs // self.hosts
        return [d // per_rank // per_host for d in range(self.D)]


def make_mesh(n_shards: int = 1, device: str | torch.device = "cuda",
              procs: int = 1) -> Mesh:
    """A 1-D mesh of n_shards row shards over `procs` processes (the
    reference's visible-device count). procs 1: every shard on `device` (the
    card unless the caller asks for the CPU), unbounded by the device count.
    procs > 1: called inside a rank of dist.procs.spawn with that many
    ranks in all (over every host of its rendezvous), on the rank's device
    (of `device`'s type), its hosts the spawn's; n_shards must divide by
    procs."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if procs < 1 or n_shards % procs:
        raise ValueError(f"{n_shards} shards do not divide over {procs} "
                         "processes")
    if procs == 1:
        return Mesh(D=int(n_shards), device=torch.device(device))
    from maxwell_tpu_torch.dist.procs import current

    group = current()
    if group is None or group.procs != procs:
        raise ValueError(
            f"a mesh over {procs} processes is made inside a rank of "
            f"dist.procs.spawn(..., {procs}), not here "
            f"({'no spawn' if group is None else f'{group.procs} ranks'})")
    if group.device.type != torch.device(device).type:
        raise ValueError(f"the rank runs on {group.device}, asked for "
                         f"{device}")
    return Mesh(D=int(n_shards), device=group.device, procs=procs,
                rank=group.rank, group=group, hosts=group.hosts)


def mesh_topology_report(mesh: Mesh) -> dict:
    """Link classes of the 1-D neighbour (halo) topology, with the
    reference's keys for a mesh whose shards lie on their ranks' hosts:
    `dcn_links` counts the neighbour pairs whose shards lie on different
    hosts, at positions p (link (p, p + 1)) = (k + 1) D / H - 1 for k < H
    - 1, the others ride the host's own links (`ici_links`); behind them
    the real ones: `real` {devices: the processes, hosts}."""
    hosts = mesh.shard_hosts()
    links = max(mesh.D - 1, 0)
    dcn = [p for p in range(mesh.D - 1) if hosts[p] != hosts[p + 1]]
    return {
        "devices": mesh.D,
        "hosts": len(set(hosts)),
        "neighbor_links": links,
        "dcn_links": len(dcn),
        "ici_links": links - len(dcn),
        "dcn_link_positions": dcn,
        "real": {"devices": mesh.procs, "hosts": mesh.hosts},
    }
