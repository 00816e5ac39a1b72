"""Sparse storage as torch tensors: blocked-ELL (BSR) for the plain "ref"
apply and the BELLUnion tile-union layout the CUDA SpMM kernels read."""

from maxwell_tpu_torch.sparse.bsr import BSRMatrix  # noqa: F401
from maxwell_tpu_torch.sparse.bellunion import BELLUnion  # noqa: F401
