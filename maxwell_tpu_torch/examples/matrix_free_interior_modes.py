"""A fully matrix-free interior-mode solve: the assembly-free 2D stencil
operator and MINRES shift-invert, no sparse matrix formed
(examples/03_matrix_free_interior_modes.py).

    python -m maxwell_tpu_torch.examples.matrix_free_interior_modes
        [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from maxwell_tpu_torch.examples._cli import parse_device, show
from maxwell_tpu_torch.problems.stencil2d import StencilPencil2D
from maxwell_tpu_torch.solvers.shift_invert import shift_invert_lanczos


def main(device="cuda", n=32, sigma=45.0, nev=4, maxiter=30,
         tol=1e-8) -> dict:
    stp = StencilPencil2D.build(nx=n, ny=n, dtype=torch.float64,
                                device=device)
    res = shift_invert_lanczos(stp, sigma=sigma, nev=nev, maxiter=maxiter,
                               tol=tol, backend="iterative")
    return {f"modes near sigma={sigma:g}": res.eigenvalues,
            "residuals": res.residuals}


if __name__ == "__main__":
    show(main(parse_device(None, __doc__)))
