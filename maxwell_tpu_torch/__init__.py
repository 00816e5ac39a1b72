"""maxwell_tpu_torch — the PyTorch/CUDA port of the JAX package (maxwell_tpu/)
for NVIDIA Hopper.

The package mirrors maxwell_tpu/ module for module (problems/, sparse/,
kernels/, solvers/, utils/ with utils/profiling.py, dist/, native/, api.py,
cli/, bench/ with the probes), plus entry.py (the flagship step `entry()`
and the distributed dry run `dryrun_multichip(n)`, the counterparts of
__graft_entry__.py) and examples/ (the ports of examples/01-04, each a
`python -m maxwell_tpu_torch.examples.<name>` entry). Plain tensor code is
PyTorch; the Pallas TPU kernels of the ported path are hand-written CUDA
for sm_90a (csrc/, built at first use by kernels/_build.py). The package imports
neither jax nor maxwell_tpu: the JAX package stays the reference that the
tests hold this port to.

    import maxwell_tpu_torch
    from maxwell_tpu_torch.problems import BrickCavity3D
    res = maxwell_tpu_torch.solve(BrickCavity3D(nx=8, ny=8, nz=8), nev=5, device="cuda")
"""

__version__ = "0.1.0"

from maxwell_tpu_torch.solvers.results import EigenResult  # noqa: F401
from maxwell_tpu_torch.api import solve  # noqa: F401
