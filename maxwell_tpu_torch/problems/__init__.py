"""Problem definitions: cavity geometries, edge-element assembly of the
curl-curl stiffness K and mass M (scipy CSR), and analytic mode oracles.
Host numpy/scipy code, identical to maxwell_tpu/problems."""

from maxwell_tpu_torch.problems.cavity2d import RectCavity2D  # noqa: F401
from maxwell_tpu_torch.problems.cavity3d import BrickCavity3D  # noqa: F401
from maxwell_tpu_torch.problems.analytic import (  # noqa: F401
    te_eigenvalues_2d,
    cavity_eigenvalues_3d,
)
