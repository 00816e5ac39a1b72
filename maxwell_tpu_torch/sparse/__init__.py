"""Sparse storage as torch tensors: blocked-ELL (BSR), which the plain "ref"
apply and the blocked-ELL CUDA kernels read, and the BELLUnion tile-union
layout of the union CUDA kernels."""

from maxwell_tpu_torch.sparse.bsr import BSRMatrix  # noqa: F401
from maxwell_tpu_torch.sparse.bellunion import BELLUnion  # noqa: F401
