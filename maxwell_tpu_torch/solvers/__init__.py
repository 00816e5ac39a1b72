"""Eigensolvers over an abstract operator (Pencil): LOBPCG with SVQB,
Rayleigh-Ritz, the gradient-nullspace projector and the shifted-CG
preconditioner, and Lanczos with thick restart, as Python loops over torch
tensors."""

from maxwell_tpu_torch.solvers.results import EigenResult  # noqa: F401
from maxwell_tpu_torch.solvers.operator import Pencil  # noqa: F401
from maxwell_tpu_torch.solvers.lobpcg import lobpcg  # noqa: F401
from maxwell_tpu_torch.solvers.lanczos import lanczos  # noqa: F401
from maxwell_tpu_torch.solvers.trlanczos import (  # noqa: F401
    thick_restart_lanczos,
)
