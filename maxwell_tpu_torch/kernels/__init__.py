"""Device kernels, hand-written CUDA for sm_90a (csrc/), with their ctypes
wrappers and plain PyTorch versions: the BELLUnion SpMM family (spmm.py),
the blocked-ELL SpMM/SpMV family (bsr_spmm.py), the BELLPairs SpMM family
(bellpairs_spmm.py), the 3D tap stencil (stencil_taps.py), the halo
kernels of the distributed pencil (halo.py) and the tile-union probes
(union_probes.py); and the nvcc build (_build.py)."""
