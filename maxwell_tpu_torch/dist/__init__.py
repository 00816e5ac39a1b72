"""Distributed pencils (maxwell_tpu/dist/): the block-row partitioner, the
stacked-view DistPencil with its halo exchange, the slab-sharded
matrix-free DistStencilPencil3D (dist/stencil_dist.py), and the shard mesh.
The shards live in one process on one device, or a DistPencil's on P
processes (dist/procs.py), D / P shards each."""

from maxwell_tpu_torch.dist.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    mesh_topology_report,
)
from maxwell_tpu_torch.dist.partition import (  # noqa: F401
    DistPencil,
    partition_problem,
)
