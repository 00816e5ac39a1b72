"""maxwell_tpu_torch LOBPCG against maxwell_tpu's on the same problem with
the same numpy start block. Degenerate clusters (2 pi^2 three times,
3 pi^2 twice on the unit cube) make eigenvector bases implementation-
dependent, so vectors are compared as subspaces."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.solvers.lobpcg import lobpcg as ref_lobpcg
from maxwell_tpu.solvers.operator import Pencil as RefPencil
from maxwell_tpu.solvers.precond import (
    shifted_cg_preconditioner as ref_precond,
)
from maxwell_tpu_torch.problems import BrickCavity3D
from maxwell_tpu_torch.solvers.lobpcg import lobpcg
from maxwell_tpu_torch.solvers.operator import Pencil
from maxwell_tpu_torch.solvers.precond import shifted_cg_preconditioner

torch.set_num_threads(1)

NEV, M_BLOCK = 5, 9
ALPHA = 2 * np.pi**2
# (reference dtype, port dtype, port kernel, tol, eigenvalue rtol,
#  subspace tolerance). f32: the port runs the union layout (b3), the
# reference its "ref" pencil (interpret mode is too slow inside a solve);
# the f32 floor of this operator sits near 1e-6, so tol is 1e-5.
CASES = {
    "f64_ref": (jnp.float64, torch.float64, "ref", 1e-8, 1e-8, 1e-6),
    "f32_union": (jnp.float32, torch.float32, "union", 1e-5, 1e-5, 1e-3),
}


def _subspace_gap(U, V, M):
    """sin of the largest principal angle between M-orthonormalized
    span(U) and span(V)."""
    def orth(A):
        w, Q = np.linalg.eigh(A.T @ (M @ A))
        return A @ (Q / np.sqrt(w))

    U, V = orth(U), orth(V)
    s = np.linalg.svd(U.T @ (M @ V), compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lobpcg_matches_reference(case):
    jdt, tdt, kernel, tol, ev_rtol, sub_tol = CASES[case]
    kw = dict(nx=6, ny=6, nz=6)
    cav = RefBrick(**kw)
    ref_pen = RefPencil.from_problem(cav, kernel="ref", dtype=jdt)
    pen = Pencil.from_problem(
        BrickCavity3D(**kw), kernel=kernel, dtype=tdt, device="cpu"
    )
    n = pen.n
    X0 = np.random.default_rng(11).standard_normal((n, M_BLOCK))
    X0_ref = np.zeros((ref_pen.n_padded, M_BLOCK))
    X0_ref[:n] = X0

    want = ref_lobpcg(
        ref_pen, nev=NEV, maxiter=150, tol=tol,
        precond=ref_precond(ref_pen, alpha=ALPHA, iters=20),
        X0=jnp.asarray(X0_ref, jdt),
    )
    got = lobpcg(
        pen, nev=NEV, maxiter=150, tol=tol,
        precond=shifted_cg_preconditioner(pen, alpha=ALPHA, iters=20),
        X0=X0,
    )
    assert want.converged and got.converged
    assert got.residuals.max() <= tol
    np.testing.assert_allclose(
        got.eigenvalues, want.eigenvalues, rtol=ev_rtol
    )
    assert np.all(np.diff(got.eigenvalues) >= 0)
    assert len(got.history) == got.iterations
    gap = _subspace_gap(
        got.eigenvectors.astype(np.float64),
        np.asarray(want.eigenvectors, np.float64), cav.M,
    )
    assert gap <= sub_tol, gap


def test_lobpcg_checkpoint_resume(tmp_path):
    """The exit-time checkpoint restarts the solve where it stopped."""
    pen = Pencil.from_problem(
        BrickCavity3D(nx=4, ny=4, nz=4), kernel="ref", dtype=torch.float64,
        device="cpu",
    )
    pc = shifted_cg_preconditioner(pen, alpha=ALPHA, iters=20)
    path = str(tmp_path / "state.npz")
    first = lobpcg(pen, nev=3, maxiter=4, tol=1e-8, precond=pc,
                   checkpoint=path)
    assert not first.converged and first.iterations == 4
    second = lobpcg(pen, nev=3, maxiter=100, tol=1e-8, precond=pc,
                    checkpoint=path)
    assert second.converged and second.iterations > 4
    assert second.history[0]["iter"] == 4


def _spd(rng, m, cond=1e3):
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    return (Q * np.logspace(0, np.log10(cond), m)) @ Q.T


@pytest.mark.parametrize("fn", ["svqb", "cholqr", "eigh_gen", "rayleigh_ritz"])
def test_rr_helpers_match_reference(fn):
    """Small dense Rayleigh-Ritz helpers against maxwell_tpu.solvers.rr in
    f64 (basis-independent quantities where eigenvectors could rotate)."""
    from maxwell_tpu.solvers import rr as ref_rr
    from maxwell_tpu_torch.solvers import rr

    rng = np.random.default_rng(21)
    n, m = 60, 6
    Mm = _spd(rng, n, cond=10.0)
    Km = _spd(rng, n, cond=1e4)
    S = rng.standard_normal((n, m))
    t = lambda a: torch.from_numpy(a)
    j = lambda a: jnp.asarray(a, jnp.float64)
    if fn == "eigh_gen":
        A, B = _spd(rng, m), _spd(rng, m, cond=10.0)
        (tw, Cw), (tg, Cg) = ref_rr.eigh_gen(j(A), j(B)), rr.eigh_gen(t(A), t(B))
        np.testing.assert_allclose(tg.numpy(), np.asarray(tw), rtol=1e-10)
        np.testing.assert_allclose(
            Cg.numpy().T @ B @ Cg.numpy(), np.eye(m), atol=1e-8
        )
    elif fn == "rayleigh_ritz":
        KS, MS = Km @ S, Mm @ S
        tw, _ = ref_rr.rayleigh_ritz(j(S), j(KS), j(MS), nev=4)
        tg, Cg = rr.rayleigh_ritz(t(S), t(KS), t(MS), nev=4)
        np.testing.assert_allclose(tg.numpy(), np.asarray(tw), rtol=1e-10)
        assert Cg.shape == (m, 4)
    else:
        out_w = getattr(ref_rr, fn)(j(S), j(Mm @ S))
        out_g = getattr(rr, fn)(t(S), t(Mm @ S))
        Sg, MSg = out_g[0].numpy(), out_g[1].numpy()
        np.testing.assert_allclose(Sg.T @ MSg, np.eye(m), atol=1e-10)
        # same M-orthogonal projector onto the same subspace
        Sw = np.asarray(out_w[0])
        np.testing.assert_allclose(Sg @ Sg.T @ Mm, Sw @ Sw.T @ Mm, atol=1e-10)
        if fn == "svqb":
            assert bool(out_g[2].all()) and bool(np.asarray(out_w[2]).all())


def test_svqb_masks_dead_columns():
    """A zero column (the empty P block of iteration 0) is masked."""
    from maxwell_tpu_torch.solvers.rr import svqb

    S = torch.from_numpy(np.random.default_rng(3).standard_normal((40, 4)))
    S[:, 2] = 0.0
    So, MSo, good, T = svqb(S, S)
    assert good.tolist().count(False) == 1
    assert torch.allclose(So, S @ T) and torch.isfinite(So).all()


def test_lobpcg_keeps_its_p_block(monkeypatch):
    """The implicit P block survives SVQB after the first iteration (the
    reference's rule drops it: its basis stays [X, W], 2m live columns), so
    the port reaches the reference's tolerance in fewer iterations from the
    same start block."""
    import importlib

    mod = importlib.import_module("maxwell_tpu_torch.solvers.lobpcg")
    svqb, live = mod.svqb, []

    def counting_svqb(S, MS, **kw):
        out = svqb(S, MS, **kw)
        if S.shape[1] == 3 * M_BLOCK:
            live.append(int(out[2].sum()))
        return out

    monkeypatch.setattr(mod, "svqb", counting_svqb)
    kw = dict(nx=6, ny=6, nz=6)
    ref_pen = RefPencil.from_problem(RefBrick(**kw), kernel="ref",
                                     dtype=jnp.float64)
    pen = Pencil.from_problem(BrickCavity3D(**kw), kernel="ref",
                              dtype=torch.float64, device="cpu")
    X0 = np.random.default_rng(11).standard_normal((pen.n, M_BLOCK))
    X0_ref = np.zeros((ref_pen.n_padded, M_BLOCK))
    X0_ref[: pen.n] = X0
    want = ref_lobpcg(
        ref_pen, nev=NEV, maxiter=150, tol=1e-9,
        precond=ref_precond(ref_pen, alpha=ALPHA, iters=20),
        X0=jnp.asarray(X0_ref, jnp.float64),
    )
    got = lobpcg(
        pen, nev=NEV, maxiter=150, tol=1e-9,
        precond=shifted_cg_preconditioner(pen, alpha=ALPHA, iters=20), X0=X0,
    )
    assert want.converged and got.converged
    assert live[0] == 2 * M_BLOCK  # P starts empty
    assert max(live[1:]) == 3 * M_BLOCK
    assert got.iterations < want.iterations
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-8)
