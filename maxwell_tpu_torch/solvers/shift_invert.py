"""Shift-invert Lanczos for interior eigenmodes near a target sigma, as in
maxwell_tpu/solvers/shift_invert.py (config 3).

K - sigma M is factored once on the host (the native LDL^T after RCM, or
scipy's splu); the factors go to the device as level-scheduled triangular
solves (kernels/tri_solve.py, one launch of the hand kernel per factor solve
on a CUDA device), and the Lanczos driver runs on the M-self-adjoint
operator

    OP x = P (K - sigma M)^-1 M x

whose eigenvalues theta map to lambda = sigma + 1/theta; the modes nearest
sigma converge first. The "iterative" backend replaces the factored solve
by MINRES on K - sigma M, matrix-free: it works on any pencil, the stencil
and distributed ones included.
"""

from __future__ import annotations

import functools

import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from maxwell_tpu_torch.kernels.tri_solve import (
    SparseLDLTDevice,
    SparseLUDevice,
)
from maxwell_tpu_torch.solvers.lanczos import lanczos
from maxwell_tpu_torch.solvers.minres import minres
from maxwell_tpu_torch.solvers.results import EigenResult
from maxwell_tpu_torch.utils.precision import fp32_true


def _si_apply(pencil, dev, x: torch.Tensor) -> torch.Tensor:
    t = pencil.M_mm(x)
    z = torch.zeros_like(x)
    z[: dev.n] = dev.solve(t[: dev.n])
    return pencil.project(z)


def _shifted_mv(pencil, sigma, z):
    Kz, Mz = pencil.KM_mm(z)
    return Kz - sigma * Mz


def _si_apply_iterative(pencil, sigma, inner_tol, inner_iters,
                        x: torch.Tensor) -> torch.Tensor:
    """Matrix-free shift-invert apply: MINRES on the symmetric-indefinite
    K - sigma M. Works with any pencil."""
    t = pencil.M_mm(x)
    A_mv = functools.partial(_shifted_mv, pencil, sigma)
    z = minres(A_mv, t, tol=inner_tol, maxiter=inner_iters,
               dot=pencil.dot_vv)
    return pencil.project(z)


def iterative_apply(pencil, sigma: float, inner_tol: float = 1e-11,
                    inner_iters: int = 400):
    """The "iterative" backend's apply: MINRES to inner_tol or inner_iters
    steps per apply."""
    return functools.partial(_si_apply_iterative, pencil, sigma, inner_tol,
                             inner_iters)


def build_shift_invert_op(pencil, sigma: float, backend: str = "auto",
                          KM=None):
    """Factor K - sigma M on the host; return the device apply.

    backend: "ldlt" (the native LDL^T, maxwell_tpu_torch/native), "splu"
    (scipy's SuperLU with partial pivoting), "iterative" (MINRES, no
    factorization) or "auto" (ldlt, and splu on a zero pivot; a missing or
    broken native build raises). KM: optional host (K, M) to factor (skips
    the device layout's to_csr round trip). The factors are in the pencil's
    dtype on its device.
    """
    if backend == "iterative":
        return iterative_apply(pencil, sigma)
    if backend not in ("auto", "ldlt", "splu"):
        raise ValueError(f"unknown shift-invert backend {backend!r}")
    if KM is not None:
        K, M = sp.csr_matrix(KM[0]), sp.csr_matrix(KM[1])
    elif pencil.kernel == "union":
        # the union pencil carries M as K's second value stream; its M is
        # None by construction and does not mean "identity"
        K = pencil.K.to_csr("a")
        M = pencil.K.to_csr("b")
    elif pencil.kernel == "bellpairs":
        raise ValueError(
            "shift_invert factorization on a bellpairs pencil: pass "
            "KM=(problem.K, problem.M) (the layout's to_csr has no "
            "second-stream export)"
        )
    else:
        K = pencil.K.to_csr()
        M = (pencil.M.to_csr() if pencil.M is not None
             else sp.eye(K.shape[0], format="csr"))
    A = (K - sigma * M).tocsc()
    where = dict(dtype=pencil.dtype, device=pencil.device)

    if backend in ("auto", "ldlt"):
        try:
            dev = SparseLDLTDevice.factor(A, **where)
            return functools.partial(_si_apply, pencil, dev)
        except ZeroDivisionError:
            if backend == "ldlt":
                raise
    dev = SparseLUDevice.from_splu(spla.splu(A), **where)
    return functools.partial(_si_apply, pencil, dev)


@fp32_true
def shift_invert_lanczos(
    pencil,
    sigma: float,
    nev: int = 5,
    maxiter: int = 60,
    tol: float = 1e-8,
    v0=None,
    generator: torch.Generator | None = None,
    backend: str = "auto",
    KM=None,
) -> EigenResult:
    """The nev eigenvalues of K x = lambda M x closest to sigma. v0 and
    generator as in lanczos()."""
    apply_op = build_shift_invert_op(pencil, sigma, backend=backend, KM=KM)
    return lanczos(pencil, nev=nev, maxiter=maxiter, tol=tol, v0=v0,
                   generator=generator, mode="shift_invert",
                   apply_op=apply_op, sigma=sigma)
