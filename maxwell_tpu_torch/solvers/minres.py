"""MINRES for symmetric (possibly indefinite) systems, the port of
maxwell_tpu/solvers/minres.py: K - sigma*M is symmetric indefinite for sigma
above the smallest eigenvalue, so CG is out; MINRES minimizes the residual
over the Krylov space with a three-term Lanczos recurrence and Givens QR.
The reference's while_loop/fori_loop bodies are Python loops here.
"""

from __future__ import annotations

from typing import Callable

import torch


def minres(
    A_mv: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    tol: float = 1e-10,
    maxiter: int = 200,
    dot: Callable | None = None,
) -> torch.Tensor:
    """Solve A x = b for symmetric A (single right-hand side). The stopping
    test reads one scalar on the host per iteration."""
    if dot is None:
        dot = lambda u, v: torch.sum(u * v)

    eps = torch.finfo(b.dtype).eps
    tol_eff = max(tol, 16.0 * eps)

    beta1 = torch.sqrt(torch.clamp(dot(b, b), min=0.0))
    safe_beta1 = torch.where(beta1 > 0, beta1, 1.0)
    v = b / safe_beta1

    x = torch.zeros_like(b)
    v_old = torch.zeros_like(b)
    w = torch.zeros_like(b)
    w_old = torch.zeros_like(b)
    one, zero = b.new_tensor(1.0), b.new_tensor(0.0)
    beta, eta = beta1, beta1
    c1, c0, s1, s0 = one, one, zero, zero
    resid = beta1
    for _ in range(maxiter):
        if not bool(resid > tol_eff * beta1):
            break
        Av = A_mv(v)
        alpha = dot(v, Av)
        r = Av - alpha * v - beta * v_old
        beta_new = torch.sqrt(torch.clamp(dot(r, r), min=0.0))
        safe_bn = torch.where(beta_new > 0, beta_new, 1.0)
        v_new = r / safe_bn

        # apply previous rotations to the new tridiagonal column
        delta = c1 * alpha - c0 * s1 * beta
        rho2 = s1 * alpha + c0 * c1 * beta
        rho3 = s0 * beta
        rho1 = torch.sqrt(delta * delta + beta_new * beta_new)
        safe_r1 = torch.where(rho1 > 0, rho1, 1.0)
        c_new = delta / safe_r1
        s_new = beta_new / safe_r1

        w_new = (v - rho3 * w_old - rho2 * w) / safe_r1
        x = x + c_new * eta * w_new
        eta = -s_new * eta

        v_old, v = v, v_new
        w_old, w = w, w_new
        beta = beta_new
        c0, c1 = c1, c_new
        s0, s1 = s1, s_new
        resid = torch.abs(eta)
    return x


def pminres_block(
    A_mv: Callable[[torch.Tensor], torch.Tensor],
    P_mv: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    iters: int = 40,
) -> torch.Tensor:
    """PRECONDITIONED block MINRES: solve A x_j = b_j per column with an
    SPD preconditioner P ~ A^-1 (Elman-Silvester-Wathen recurrence,
    per-column scalars vectorized over the block; a fixed iteration count,
    no host reads).

    Built for the loaded-cavity device refinement: A = K - sigma_j M
    (symmetric indefinite, per-column shifts folded into A_mv), P = the SPD
    vacuum (K + alpha M)^-1 spectral solve."""

    def dots(u, v):
        return torch.sum(u * v, dim=0)  # (m,)

    m = B.shape[1]
    zeros = torch.zeros_like(B)
    one = B.new_ones((m,))
    z1 = P_mv(B)
    gamma1 = torch.sqrt(torch.clamp(dots(z1, B), min=1e-30))
    v0, v1 = zeros, B
    gamma0 = one
    w0, w1 = zeros, zeros
    c0, c1 = one, one
    s0, s1 = torch.zeros_like(one), torch.zeros_like(one)
    eta, x = gamma1, zeros
    for _ in range(iters):
        z = z1 / gamma1[None, :]
        Az = A_mv(z)
        delta = dots(Az, z)
        v_new = (
            Az
            - (delta / gamma1)[None, :] * v1
            - (gamma1 / gamma0)[None, :] * v0
        )
        z_new = P_mv(v_new)
        gamma_new = torch.sqrt(torch.clamp(dots(z_new, v_new), min=1e-30))
        a0 = c1 * delta - c0 * s1 * gamma1
        a1 = torch.sqrt(a0 * a0 + gamma_new * gamma_new)
        a2 = s1 * delta + c0 * c1 * gamma1
        a3 = s0 * gamma1
        c_new = a0 / a1
        s_new = gamma_new / a1
        w_new = (z - a3[None, :] * w0 - a2[None, :] * w1) / a1[None, :]
        x = x + (c_new * eta)[None, :] * w_new
        v0, v1, z1 = v1, v_new, z_new
        gamma0, gamma1 = gamma1, gamma_new
        w0, w1 = w1, w_new
        c0, c1, s0, s1 = c1, c_new, s1, s_new
        eta = -s_new * eta
    return x
