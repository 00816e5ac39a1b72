"""The lowest resonant modes of a vacuum rectangular cavity, against the
analytic spectrum pi^2 (m^2/a^2 + n^2/b^2) (examples/01_cavity_modes.py).

    python -m maxwell_tpu_torch.examples.cavity_modes [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

import maxwell_tpu_torch
from maxwell_tpu_torch.examples._cli import parse_device, show
from maxwell_tpu_torch.problems import RectCavity2D


def main(device="cuda", nx=48, ny=34, nev=6, tol=1e-9) -> dict:
    cav = RectCavity2D(a=1.0, b=0.7, nx=nx, ny=ny)
    res = maxwell_tpu_torch.solve(cav, nev=nev, tol=tol, device=device)
    exact = cav.analytic_eigenvalues(nev)
    out = {"computed": res.eigenvalues, "analytic": exact,
           "rel err": np.abs(res.eigenvalues - exact) / exact,
           "residuals": res.residuals}
    return out


if __name__ == "__main__":
    show(main(parse_device(None, __doc__)))
