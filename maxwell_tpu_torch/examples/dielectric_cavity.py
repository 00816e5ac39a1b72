"""A dielectric-loaded 3D cavity: permittivity 4 in half the cells pulls
the modes down (examples/02_dielectric_cavity.py).

    python -m maxwell_tpu_torch.examples.dielectric_cavity [--device cpu]
"""

from __future__ import annotations

import numpy as np

import maxwell_tpu_torch
from maxwell_tpu_torch.examples._cli import parse_device, show
from maxwell_tpu_torch.problems import BrickCavity3D


def main(device="cuda", n=8, nev=3) -> dict:
    eps = np.ones((n, n, n))
    eps[: n // 2] = 4.0  # half-filled dielectric slab
    vacuum = maxwell_tpu_torch.solve(BrickCavity3D(nx=n, ny=n, nz=n),
                                     nev=nev, device=device)
    loaded = maxwell_tpu_torch.solve(
        BrickCavity3D(nx=n, ny=n, nz=n, eps_r=eps), nev=nev,
        precond_alpha=10.0, device=device)
    return {"vacuum": vacuum.eigenvalues,
            "loaded": loaded.eigenvalues,
            "residuals": np.concatenate([vacuum.residuals,
                                         loaded.residuals])}


if __name__ == "__main__":
    show(main(parse_device(None, __doc__)))
