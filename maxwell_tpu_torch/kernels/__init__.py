"""Device kernels, hand-written CUDA for sm_90a (csrc/), with their ctypes
wrappers and plain PyTorch versions: the BELLUnion SpMM family (spmm.py),
the blocked-ELL SpMM/SpMV family (bsr_spmm.py) and the 3D tap stencil
(stencil_taps.py); and the nvcc build (_build.py)."""
