"""maxwell_tpu_torch — the PyTorch/CUDA port of the JAX package (maxwell_tpu/)
for NVIDIA Hopper.

The package mirrors maxwell_tpu/ module for module (problems/, sparse/,
kernels/, solvers/, utils/, api.py, cli/). Plain tensor code is PyTorch; the
Pallas TPU kernels of the ported path are hand-written CUDA for sm_90a
(csrc/, built at first use by kernels/_build.py). The package imports
neither jax nor maxwell_tpu: the JAX package stays the reference that the
tests hold this port to.

    import maxwell_tpu_torch
    from maxwell_tpu_torch.problems import BrickCavity3D
    res = maxwell_tpu_torch.solve(BrickCavity3D(nx=8, ny=8, nz=8), nev=5, device="cuda")
"""

__version__ = "0.1.0"

from maxwell_tpu_torch.solvers.results import EigenResult  # noqa: F401
from maxwell_tpu_torch.api import solve  # noqa: F401
