"""The shard mesh of a distributed pencil (maxwell_tpu/dist/mesh.py).

The reference builds a 1-D JAX device mesh, one device per shard, and runs
its solvers per shard under shard_map. The port holds all D shards of a
row-sharded pencil in one process on one torch device, in a stacked view
(dist/partition.py): shard d owns rows [d Lb, (d + 1) Lb) of every vector.
So a mesh is D shards on a device, and its halo links are the D - 1
neighbour pairs of that one device: one host, no link crossing hosts.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D row shards held on `device`."""

    D: int
    device: torch.device


def make_mesh(n_shards: int = 1, device: str | torch.device = "cuda") -> Mesh:
    """A 1-D mesh of n_shards row shards on one device (the card unless the
    caller asks for the CPU). Unlike the reference, the shard count is not
    bounded by the device count: every shard lives on the same device."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return Mesh(D=int(n_shards), device=torch.device(device))


def mesh_topology_report(mesh: Mesh) -> dict:
    """Link classes of the 1-D neighbour (halo) topology, with the
    reference's keys: every shard on one device of one host, so all D - 1
    neighbour links are local and none crosses hosts."""
    links = max(mesh.D - 1, 0)
    return {
        "devices": mesh.D,
        "hosts": 1,
        "neighbor_links": links,
        "dcn_links": 0,
        "ici_links": links,
        "dcn_link_positions": [],
    }
