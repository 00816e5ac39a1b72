"""Device kernels: the BELLUnion SpMM family as hand-written CUDA for
sm_90a (csrc/bellunion_spmm.cu), their ctypes wrappers and plain PyTorch
versions (spmm.py), and the nvcc build (_build.py)."""
