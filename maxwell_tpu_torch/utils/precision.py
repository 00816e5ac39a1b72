"""fp32-true matmul precision for the solver path.

The solvers build Gram matrices, orthonormalize bases and rotate Ritz blocks
with dense products; at reduced precision (TF32 keeps ~10 mantissa bits)
LOBPCG stalls far above its f32 residual floor. PyTorch's float32 matmul on
CUDA defaults to full f32, but process-wide settings can turn TF32 on for
matmuls (`torch.backends.cuda.matmul.allow_tf32`,
`torch.set_float32_matmul_precision`) and cuDNN convolutions use TF32 by
default. Every solver entry point therefore runs under `solver_precision()`,
which forces true f32 and restores the caller's settings on exit.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def solver_precision():
    """Context manager: TF32 off for matmul and cuDNN, "highest" float32
    matmul precision; the previous settings come back on exit."""
    prev = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        # the precision setter also rewrites allow_tf32: restore it first
        torch.set_float32_matmul_precision(prev[2])
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def fp32_true(fn):
    """Decorator: run `fn` under solver precision."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with solver_precision():
            return fn(*args, **kwargs)

    return wrapper
