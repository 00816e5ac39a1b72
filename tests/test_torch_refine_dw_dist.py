"""The distributed double-word refinement of maxwell_tpu_torch
(solvers/refine_device.refine_dw_dist) and the CLI's slab-sharded stencil
runs, at the JAX package's own test size (tests/distributed/
test_refine_dw_dist.py: the 16^3 brick in 8 slabs): the dw slab apply
against an f64 apply (< 1e-12), the cross-slab dw sums, an f32
distributed LOBPCG block refined to an f64-verified residual <= 2e-8
(and against the reference's own refinement of the same block), and
shrunk copies of configs 4_stencil and 5 through the port's CLI."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist.stencil_dist import (
    DistStencilPencil3D as RefDistStencil,
)
from maxwell_tpu.solvers.refine_device import (
    refine_dw_dist as ref_refine_dw_dist,
)
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.dist import make_mesh
from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
from maxwell_tpu_torch.problems import BrickCavity3D
from maxwell_tpu_torch.problems.analytic import cavity_eigenvalues_3d
from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
from maxwell_tpu_torch.solvers import refine_device
from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist
from maxwell_tpu_torch.solvers.refine_device import refine_dw_dist
from maxwell_tpu_torch.utils import twofloat as tf

torch.set_num_threads(1)

D = 8
N = 16
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.fixture(scope="module")
def dsp():
    return DistStencilPencil3D.build(nx=N, ny=N, nz=N, D=D,
                                     dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def p64():
    return StencilPencil3D.build(nx=N, ny=N, nz=N, dtype=torch.float64,
                                 device="cpu")


@pytest.fixture(scope="module")
def block32(dsp):
    res = lobpcg_dist(dsp, make_mesh(D, "cpu"), nev=4, maxiter=60, tol=1e-5,
                      precond="spectral", precond_alpha=15.0)
    assert res.residuals.max() < 1e-2
    return res


def _f64_residuals(p64, X, th):
    Xp = torch.zeros((p64.n_padded, X.shape[1]), dtype=torch.float64)
    Xp[: p64.n] = torch.from_numpy(X[: p64.n])
    KX, MX = (Y[: p64.n].numpy() for Y in p64.KM_mm(Xp))
    R = KX - MX * th[None, :]
    scale = np.linalg.norm(KX, axis=0) + np.abs(th) * np.linalg.norm(MX,
                                                                    axis=0)
    return np.linalg.norm(R, axis=0) / scale


def test_dw_slab_apply_matches_f64(dsp, p64):
    rng = np.random.default_rng(0)
    X64 = rng.standard_normal((p64.n_padded, 3)) * p64.mask.numpy()[:, None]
    Xh_g, Xl_g = tf.dw_from_f64(X64)
    X64 = tf.dw_to_f64(Xh_g, Xl_g)
    Xh, Xl = (dsp.inject_vectors(v[: dsp.n_full]).float()
              for v in (Xh_g, Xl_g))
    (KXh, KXl), (MXh, MXl) = dsp.KM_mm_dw(Xh, Xl)
    KX, MX = (Y[: p64.n].numpy()
              for Y in p64.KM_mm(torch.from_numpy(X64)))
    for (h, l_), want in (((KXh, KXl), KX), ((MXh, MXl), MX)):
        got = tf.dw_to_f64(dsp.extract_vectors(h), dsp.extract_vectors(l_))
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 1e-12, f"dist dw apply off by {rel:.2e}"
    # one operator alone is the same words
    KXh1, KXl1 = dsp.KM_mm_dw(Xh, Xl, want_M=False)[0]
    assert torch.equal(KXh1, KXh) and torch.equal(KXl1, KXl)


def test_dw_allsum_pairs_is_exact_to_the_pair():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((D, 5)) * 10.0 ** rng.integers(-6, 6, (D, 5))
    h, l_ = (torch.from_numpy(v) for v in tf.dw_from_f64(x))
    sh, sl = refine_device._dw_allsum_pairs(h, l_)
    exact = tf.dw_to_f64(h, l_).sum(axis=0)
    got = tf.dw_to_f64(sh, sl)
    assert np.abs(got - exact).max() <= 1e-13 * np.abs(exact).max()


def test_refine_dw_dist_reaches_1e8(dsp, p64, block32):
    out = refine_dw_dist(dsp, make_mesh(D, "cpu"), block32.eigenvectors,
                         tol=1e-8)
    assert out.converged, f"residuals {out.residuals}"
    assert out.eigenvectors.shape == (dsp.n_full, 4)
    rel = _f64_residuals(p64, out.eigenvectors, out.eigenvalues)
    assert rel.max() <= 2e-8, f"f64-verified residual {rel.max():.2e}"
    np.testing.assert_allclose(np.sort(out.eigenvalues),
                               cavity_eigenvalues_3d(1.0, 1.0, 1.0, 4),
                               rtol=0.05)
    assert out.history[-1]["max_rel_res"] == out.residuals.max()


def test_refine_dw_dist_matches_reference(dsp, block32):
    """The same f32 block through the reference's refinement on its mesh:
    the same eigenvalues."""
    assert jax.device_count() >= D
    ref = RefDistStencil.build(nx=N, ny=N, nz=N, D=D, dtype=jnp.float32)
    want = ref_refine_dw_dist(ref, ref_make_mesh(D), block32.eigenvectors,
                              tol=1e-8)
    got = refine_dw_dist(dsp, None, block32.eigenvectors, tol=1e-8)
    assert got.converged and want.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues,
                               rtol=1e-11)
    assert got.iterations == want.iterations


def test_refine_dw_dist_takes_a_stacked_block(dsp, block32):
    X = dsp.inject_vectors(block32.eigenvectors)
    a = refine_dw_dist(dsp, None, X, tol=1e-8)
    b = refine_dw_dist(dsp, None, block32.eigenvectors, tol=1e-8)
    np.testing.assert_array_equal(a.eigenvalues, b.eigenvalues)
    np.testing.assert_array_equal(a.eigenvectors, b.eigenvectors)


def test_refine_dw_dist_refusals(dsp, block32):
    loaded = DistStencilPencil3D.build(
        nx=8, ny=3, nz=3, D=4, eps_r=np.full((8, 3, 3), 2.0), device="cpu")
    with pytest.raises(ValueError, match="vacuum slab tap pencil"):
        refine_dw_dist(loaded, None, np.zeros((loaded.n_full, 1)))
    with pytest.raises(ValueError, match="shards"):
        refine_dw_dist(dsp, make_mesh(4, "cpu"), block32.eigenvectors)


def _discrete(n, k):
    cav = BrickCavity3D(nx=n, ny=n, nz=n)
    w = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(), eigvals_only=True)
    return np.sort(w[w > 1e-8])[:k]


def _run_cli(cfg, tmp_path, capsys, name):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    assert port_cli.main([str(path), "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _shrunk(name, **solver):
    """A config of configs/ on the 8^3 brick in 4 slabs."""
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["problem"].update(nx=8, ny=8, nz=8)
    cfg["dist"]["n_shards"] = 4
    cfg["solver"].update(solver)
    return cfg


def test_cli_config4_stencil_shrunk(tmp_path, capsys, monkeypatch):
    """Config 4_stencil as written but 8^3 in 4 slabs: f64 lobpcg_dist with
    the distributed spectral preconditioner, then refine_dw_dist."""
    calls = []
    real = refine_device.refine_dw_dist
    monkeypatch.setattr(refine_device, "refine_dw_dist",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rep = _run_cli(_shrunk("config4_stencil"), tmp_path, capsys, "c4s")
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert rep["n"] == 3 * 8 * 9 * 9
    assert calls == [1] and "t_refine_s" in rep
    np.testing.assert_allclose(rep["eigenvalues"], _discrete(8, 5),
                               rtol=1e-9)


def test_cli_config5_staged_polish_shrunk(tmp_path, capsys, monkeypatch):
    """Config 5 shrunk (8^3 in 4 slabs, nev 8, batch 4): each stage's
    block polished by refine_dw_dist before it is deflated, no final
    refinement."""
    calls = []
    real = refine_device.refine_dw_dist
    monkeypatch.setattr(refine_device, "refine_dw_dist",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rep = _run_cli(_shrunk("config5", nev=8, batch=4), tmp_path, capsys,
                   "c5s")
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert calls == [1, 1] and "t_refine_s" not in rep
    np.testing.assert_allclose(rep["eigenvalues"], _discrete(8, 8),
                               rtol=1e-9)


def test_cli_batch_not_below_nev_refines_at_the_end(tmp_path, capsys,
                                                    monkeypatch):
    """batch >= nev runs no stages, so no stage is polished: the run is
    refined at the end (the reference skips that refinement too)."""
    calls = []
    real = refine_device.refine_dw_dist
    monkeypatch.setattr(refine_device, "refine_dw_dist",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rep = _run_cli(_shrunk("config5", nev=4, batch=4), tmp_path, capsys,
                   "c5b")
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert calls == [1] and "t_refine_s" in rep
