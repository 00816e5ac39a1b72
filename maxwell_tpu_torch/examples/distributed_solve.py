"""A distributed eigensolve: the 8^3 brick's pencil in row shards, all on
one device (examples/04_distributed_solve.py, which shards over the
visible devices).

    python -m maxwell_tpu_torch.examples.distributed_solve
        [--device cuda|cpu]
"""

from __future__ import annotations

import maxwell_tpu_torch
from maxwell_tpu_torch.examples._cli import parse_device
from maxwell_tpu_torch.problems import BrickCavity3D


def main(device="cuda", n=8, shards=8, nev=3, maxiter=80):
    return maxwell_tpu_torch.solve(
        BrickCavity3D(nx=n, ny=n, nz=n), nev=nev, distributed=True,
        n_shards=shards, maxiter=maxiter, device=device)


if __name__ == "__main__":
    print(main(parse_device(None, __doc__)))
