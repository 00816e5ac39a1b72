"""The matrix-free road to 1e-8 of maxwell_tpu_torch against maxwell_tpu's:
MINRES and block preconditioned MINRES, then the whole slice at 8^3 (f32
LOBPCG with the spectral preconditioner from one numpy start block, then the
double-word device refinement `refine_dw`) for the vacuum brick and the
half-filled dielectric, and the CLI on config 7. All on the CPU.

Bounds: refined eigenvalues agree with the reference's refine_dw to 1e-9
relative; the refined vectors' residuals, recomputed with an independent
f64 pencil, are <= 2e-8 (the bound of tests/unit/test_refine_device.py).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.problems.stencil3d import StencilPencil3D as RefStencil3D
from maxwell_tpu.solvers import lobpcg as ref_lobpcg
from maxwell_tpu.solvers.refine_device import refine_dw as ref_refine_dw
from maxwell_tpu.solvers.spectral import (
    spectral_preconditioner as ref_precond,
)
from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
from maxwell_tpu_torch.solvers.lobpcg import lobpcg
from maxwell_tpu_torch.solvers.refine_device import refine_dw
from maxwell_tpu_torch.solvers.spectral import spectral_preconditioner

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_minres_matches_reference():
    from maxwell_tpu.solvers.minres import minres as ref_minres
    from maxwell_tpu_torch.solvers.minres import minres

    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((60, 60)))
    A = Q @ np.diag(np.linspace(-3.0, 5.0, 60) + 0.05) @ Q.T  # indefinite
    b = rng.standard_normal(60)
    for maxiter in (7, 200):
        got = minres(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(b),
                     tol=1e-12, maxiter=maxiter).numpy()
        want = np.asarray(ref_minres(lambda v: jnp.asarray(A) @ v,
                                     jnp.asarray(b), tol=1e-12,
                                     maxiter=maxiter))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)
    assert np.linalg.norm(A @ got - b) <= 1e-9 * np.linalg.norm(b)


def test_pminres_block_matches_reference():
    from maxwell_tpu.solvers.minres import pminres_block as ref_pminres
    from maxwell_tpu_torch.solvers.minres import pminres_block

    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.standard_normal((50, 50)))
    A = Q @ np.diag(np.linspace(-2.0, 6.0, 50) + 0.03) @ Q.T
    P = np.diag(1.0 / (1.0 + np.arange(50) / 10.0))  # SPD
    B = rng.standard_normal((50, 3))
    # 15 steps: the recurrences agree to ~1e-15 there; past ~25 steps
    # lost orthogonality amplifies the summation-order differences
    got = pminres_block(lambda Z: torch.from_numpy(A) @ Z,
                        lambda Z: torch.from_numpy(P) @ Z,
                        torch.from_numpy(B), iters=15).numpy()
    want = np.asarray(ref_pminres(lambda Z: jnp.asarray(A) @ Z,
                                  lambda Z: jnp.asarray(P) @ Z,
                                  jnp.asarray(B), iters=15))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def _f64_residuals(kw, X, theta):
    """Relative residuals of (theta, X) against an f64 pencil built apart."""
    p64 = StencilPencil3D.build(nx=8, ny=8, nz=8, dtype=torch.float64,
                                device="cpu", **kw)
    Xp = torch.zeros((p64.n_padded, X.shape[1]), dtype=torch.float64)
    Xp[: p64.n] = torch.from_numpy(X)
    KX, MX = p64.KM_mm(Xp)
    th = torch.from_numpy(np.asarray(theta, np.float64))
    R = KX - MX * th[None, :]
    scale = KX.norm(dim=0) + th.abs() * MX.norm(dim=0)
    return (R.norm(dim=0) / scale).numpy()


@pytest.mark.parametrize("case", ["vacuum", "eps_half"])
def test_slice_at_8_matches_reference(case):
    """f32 LOBPCG (spectral preconditioner, stall cut) from the same numpy
    X0, then refine_dw, in both packages."""
    kw, nev, alpha, maxiter, stall = {}, 5, 15.0, 60, 10
    if case == "eps_half":
        eps = np.ones((8, 8, 8))
        eps[:4] = 2.5
        kw, nev, alpha, maxiter, stall = {"eps_r": eps}, 4, 12.0, 120, 12
    ref = RefStencil3D.build(nx=8, ny=8, nz=8, dtype=jnp.float32, **kw)
    port = StencilPencil3D.build(nx=8, ny=8, nz=8, dtype=torch.float32,
                                 device="cpu", **kw)
    m = nev + 4
    X0 = np.zeros((port.n_padded, m), np.float32)
    X0[: port.n] = np.random.default_rng(3).standard_normal((port.n, m))
    opts = dict(nev=nev, maxiter=maxiter, tol=1e-5, stall_window=stall)
    want32 = ref_lobpcg(ref, precond=ref_precond(ref, alpha),
                        X0=jnp.asarray(X0), **opts)
    got32 = lobpcg(port, precond=spectral_preconditioner(port, alpha),
                   X0=X0, **opts)
    assert got32.residuals.max() < 1e-3 and want32.residuals.max() < 1e-3

    want = ref_refine_dw(ref, want32.eigenvectors, tol=1e-8)
    got = refine_dw(port, got32.eigenvectors, tol=1e-8)
    assert got.converged and want.converged, (got.residuals, want.residuals)
    assert got.eigenvectors.shape == (port.n, nev)
    # the early exit fired before the cap (5 sweeps vacuum, 8 loaded). The
    # port's LOBPCG keeps its P block, unlike the reference's, and hands
    # over another f32 block: the loaded one takes 3-4 sweeps here
    assert got.iterations <= 5
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-9)
    rel = _f64_residuals(kw, got.eigenvectors, got.eigenvalues)
    assert rel.max() <= 2e-8, rel


def test_refine_dw_rejects_pmc():
    pmc = StencilPencil3D.build(nx=4, ny=4, nz=4, dtype=torch.float32,
                                bc="pmc", device="cpu")
    with pytest.raises(ValueError):
        refine_dw(pmc, np.zeros((pmc.n, 2), np.float32))


def test_cli_config7(capsys, tmp_path):
    """configs/config7_dielectric.json at 6^3 through the port's CLI on the
    CPU (loaded cavity: f32 LOBPCG, then the dw refinement with block
    MINRES corrections), held to the dense f64 eigenvalues of the
    reference's pencil."""
    import scipy.linalg

    from maxwell_tpu.cli.run import material_grids
    from maxwell_tpu_torch.cli import run as port_cli

    with open(os.path.join(CONFIGS, "config7_dielectric.json")) as f:
        cfg = json.load(f)
    cfg["problem"].update(nx=6, ny=6, nz=6)
    path = tmp_path / "config7_6.json"
    path.write_text(json.dumps(cfg))
    assert port_cli.main([str(path), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    got = json.loads([l for l in lines if l.startswith("{")][-1])
    assert got["converged"] and max(got["residuals"]) <= 1e-8
    assert "t_refine_s" in got

    eps_r, _ = material_grids(cfg["problem"])
    ref = RefStencil3D.build(nx=6, ny=6, nz=6, dtype=jnp.float64,
                             eps_r=eps_r)
    live = np.asarray(ref.mask) != 0
    eye = jnp.asarray(np.eye(ref.n_padded)[:, live])
    K = np.asarray(ref.K_mm(eye))[live]
    M = np.asarray(ref.M_mm(eye))[live]
    lam = scipy.linalg.eigh(K, M, eigvals_only=True)
    want = lam[lam > 1e-6 * lam.max()][:4]  # above the gradient nullspace
    assert got["n"] == ref.n
    np.testing.assert_allclose(got["eigenvalues"], want, rtol=1e-9)


def test_cli_loaded_pmc_stencil_refine_f64_pencil(capsys, tmp_path):
    """A loaded PMC 3D stencil config with refinement: refine_dw takes PEC
    pencils only, so the CLI polishes with `refine_f64_pencil` on the same
    pencil rebuilt at f64, materials included. Held to the dense f64
    eigenvalues of the reference's loaded PMC pencil, which differ from the
    vacuum ones (the reference CLI rebuilds this polish without materials;
    ROADMAP.md, Queue 3)."""
    import scipy.linalg

    from maxwell_tpu.cli.run import material_grids
    from maxwell_tpu_torch.cli import run as port_cli

    cfg = {
        "problem": {"kind": "brick3d", "nx": 5, "ny": 5, "nz": 5,
                    "bc": "pmc",
                    "materials": {"eps_fill": {
                        "value": 2.5, "box": [0, 0.6, 0, 1, 0, 1]}}},
        "solver": {"kind": "lobpcg", "nev": 3, "tol": 1e-8, "maxiter": 150,
                   "precond_alpha": 10.0, "refine": True},
        "storage": {"dtype": "f32", "operator": "stencil"},
    }
    path = tmp_path / "pmc_loaded_stencil.json"
    path.write_text(json.dumps(cfg))
    assert port_cli.main([str(path), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    got = json.loads([l for l in lines if l.startswith("{")][-1])
    assert got["converged"] and max(got["residuals"]) <= 1e-8

    def dense_eigenvalues(**kw):
        ref = RefStencil3D.build(nx=5, ny=5, nz=5, dtype=jnp.float64,
                                 bc="pmc", **kw)
        live = np.asarray(ref.mask) != 0
        eye = jnp.asarray(np.eye(ref.n_padded)[:, live])
        K = np.asarray(ref.K_mm(eye))[live]
        M = np.asarray(ref.M_mm(eye))[live]
        lam = scipy.linalg.eigh(K, M, eigvals_only=True)
        return lam[lam > 1e-6 * lam.max()][:3]  # above the nullspace

    eps_r, _ = material_grids(cfg["problem"])
    want = dense_eigenvalues(eps_r=eps_r)
    np.testing.assert_allclose(got["eigenvalues"], want, rtol=1e-9)
    vacuum = dense_eigenvalues()
    assert np.abs(want - vacuum).min() > 1e-2 * vacuum.max()


def test_cli_rect2d_stencil_refine_f64_pencil(capsys, tmp_path):
    """A 2D stencil config with refinement: the f32 solve, then the f64
    CPU polish `refine_f64_pencil` (refine_dw takes 3D PEC pencils only),
    held to the dense f64 eigenvalues of the reference's 2D pencil."""
    import scipy.linalg

    from maxwell_tpu.problems.stencil2d import StencilPencil2D as RefStencil2D
    from maxwell_tpu_torch.cli import run as port_cli

    cfg = {
        "problem": {"kind": "rect2d", "a": 1.0, "b": 0.7, "nx": 8, "ny": 6},
        "solver": {"kind": "lobpcg", "nev": 4, "tol": 1e-8, "maxiter": 100,
                   "precond_alpha": 10.0, "refine": True},
        "storage": {"dtype": "f32", "operator": "stencil"},
    }
    path = tmp_path / "rect2d_stencil.json"
    path.write_text(json.dumps(cfg))
    assert port_cli.main([str(path), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    got = json.loads([l for l in lines if l.startswith("{")][-1])
    assert got["converged"] and max(got["residuals"]) <= 1e-8

    ref = RefStencil2D.build(a=1.0, b=0.7, nx=8, ny=6, dtype=jnp.float64)
    live = np.asarray(ref.mask) != 0
    eye = jnp.asarray(np.eye(ref.n_padded)[:, live])
    K = np.asarray(ref.K_mm(eye))[live]
    M = np.asarray(ref.M_mm(eye))[live]
    lam = scipy.linalg.eigh(K, M, eigvals_only=True)
    want = lam[lam > 1e-6 * lam.max()][:4]
    np.testing.assert_allclose(got["eigenvalues"], want, rtol=1e-9)
