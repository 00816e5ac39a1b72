"""maxwell_tpu_torch on a CUDA device: the hand-written kernels against
their plain PyTorch versions, and the solves and CLI through them.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. The file imports
neither jax nor maxwell_tpu, so on a machine with the card and no JAX it
runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import maxwell_tpu_torch
from maxwell_tpu_torch.bench import (
    exp_gather,
    exp_grid,
    exp_stencil2,
    exp_union,
)
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.dist import partition_problem
from maxwell_tpu_torch.kernels import bellpairs_spmm as kp
from maxwell_tpu_torch.kernels import bsr_spmm, halo, spmm, stencil_taps as kst
from maxwell_tpu_torch.kernels import gather_probes as gpr
from maxwell_tpu_torch.kernels import grid_probes as gp
from maxwell_tpu_torch.kernels import spmm_probes as spp
from maxwell_tpu_torch.kernels import stencil_probes as spr
from maxwell_tpu_torch.kernels import union_probes as up
from maxwell_tpu_torch.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist
from maxwell_tpu_torch.sparse.bellpairs import BELLPairs
from maxwell_tpu_torch.sparse.bellunion import BELLUnion
from maxwell_tpu_torch.sparse.bsr import BSRMatrix
from maxwell_tpu_torch.sparse.reorder import PermutedProblem

torch.set_num_threads(1)

# f32 summation order differs from the plain version's
TOL = {"highest": 1e-5, "b3": 2e-5}
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def layout():
    cav = PermutedProblem(BrickCavity3D(nx=6, ny=5, nz=4))
    return BELLUnion.from_csr(cav.K, B=cav.M, device="cpu").bf16x3()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "b3"])
@pytest.mark.parametrize("m", [1, 3, 9, 17, 33])
def test_cuda_kernels_match_plain(layout, cuda_device, m, precision):
    A = layout.to(cuda_device)
    X = torch.from_numpy(
        np.random.default_rng(m).standard_normal((A.n_padded, m))
    ).float().to(cuda_device)
    Rk, Rm = spmm.bellunion_km_matmat_ref(A, X, precision=precision)
    Yk, Ym = spmm.bellunion_km_matmat(A, X, precision=precision)
    Y1 = spmm.bellunion_matmat(A, X, "a", precision)
    y = spmm.bellunion_matvec(A, X[:, 0].contiguous(), "b", precision)
    for got, want in ((Yk, Rk), (Ym, Rm), (Y1, Rk), (y, Rm[:, 0])):
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= TOL[precision]
    assert torch.equal(Yk, Y1)  # same per-element arithmetic, fixed order


def _pair_layout(device):
    """Two random CSRs whose patterns differ (sub-blocks live in one
    stream only), one chunk of 63 live runs per tile."""
    n = 1000
    A = sp.random(n, n, density=0.01, format="csr", random_state=7)
    B = sp.random(n, n, density=0.008, format="csr", random_state=8)
    return BELLUnion.from_csr(A, B=B, device=device).bf16x3()


def _xs(A, m, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (A.n_padded, m))).float().to(A.vals.device)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "b3"])
@pytest.mark.parametrize("m", [1, 9, 17, 33])
def test_cuda_union_pair_fused_equals_single(cuda_device, m, precision):
    """On the pair whose patterns differ: K1 == K2 bit for bit on each
    stream (one live list, the same products per stream), and both within
    the union bound of the plain version (17, 33: several column
    slices)."""
    A = _pair_layout(cuda_device)
    X = _xs(A, m, seed=m)
    Yk, Ym = spmm.bellunion_km_matmat(A, X, precision=precision)
    assert torch.equal(Yk, spmm.bellunion_matmat(A, X, "a", precision))
    assert torch.equal(Ym, spmm.bellunion_matmat(A, X, "b", precision))
    for got, want in zip((Yk, Ym), spmm.bellunion_km_matmat_ref(
            A, X, precision=precision)):
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= TOL[precision]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "b3"])
def test_cuda_union_empty_tile_gives_zeros(cuda_device, precision):
    """A tile whose rows are all zero keeps a chunk with no live sub-block:
    the kernels write exact zeros there (Y is not pre-zeroed)."""
    cav = PermutedProblem(BrickCavity3D(nx=6, ny=6, nz=6))
    keep = np.ones(cav.K.shape[0])
    keep[128:256] = 0.0
    D = sp.diags(keep)
    A = BELLUnion.from_csr(D @ cav.K, B=D @ cav.M,
                           device=cuda_device).bf16x3()
    tile1 = A.live.sb_ptr[16 * int(A.tile_ptr[1]): 16 * int(A.tile_ptr[2])
                          + 1]
    assert int(tile1[-1] - tile1[0]) == 0
    X = _xs(A, 9, seed=3)
    for Y in (*spmm.bellunion_km_matmat(A, X, precision=precision),
              spmm.bellunion_matmat(A, X, "b", precision)):
        assert torch.equal(Y[128:256], torch.zeros_like(Y[128:256]))
    Rk, _ = spmm.bellunion_km_matmat_ref(A, X, precision=precision)
    Yk = spmm.bellunion_matmat(A, X, "a", precision)
    assert ((Yk - Rk).abs().max() / Rk.abs().max()).item() <= TOL[precision]


@pytest.mark.cuda
def test_cuda_union_without_live_form_raises(layout, cuda_device):
    A = dataclasses.replace(layout.to(cuda_device), live=None)
    X = _xs(A, 9, seed=1)
    for call in (lambda: spmm.bellunion_matmat(A, X),
                 lambda: spmm.bellunion_km_matmat(A, X, precision="b3"),
                 lambda: spmm.bellunion_matvec(A, X[:, 0].contiguous()),
                 lambda: halo.union_interior_overlap(A, X, 1, 0)):
        with pytest.raises(ValueError, match="live"):
            call()


@pytest.mark.cuda
def test_cuda_solve_matches_cpu_plain(cuda_device):
    """The f32 solve through the kernels on the card against the same solve
    through their plain versions on the CPU, both refined to 1e-8."""
    prob = PermutedProblem(BrickCavity3D(nx=6, ny=6, nz=6))
    X0 = np.random.default_rng(2).standard_normal((prob.K.shape[0], 9))
    opts = dict(nev=5, tol=1e-8, dtype=torch.float32, kernel="union",
                stall_window=12, X0=X0)
    spmm.reset_counts()
    got = maxwell_tpu_torch.solve(prob, device=cuda_device, **opts)
    counts = spmm.counts()
    want = maxwell_tpu_torch.solve(prob, device="cpu", **opts)
    assert got.converged and got.residuals.max() <= 1e-8
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-7)
    assert counts["bellunion_km_matmat"] > 0
    assert counts["bellunion_km_matmat_ref"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_cuda_cli_brick(cuda_device, capsys, tmp_path, dtype):
    """The CLI on the card: f64 takes the blocked-ELL path, f32 the union
    kernels (with the host f64 refine)."""
    cfg = {
        "problem": {"kind": "brick3d", "nx": 6, "ny": 6, "nz": 6},
        "solver": {"kind": "lobpcg", "nev": 5, "tol": 1e-8, "maxiter": 100,
                   "precond_alpha": 19.7, "refine": dtype == "f32"},
        "storage": {"dtype": dtype, "kernel": "auto"},
    }
    path = tmp_path / "brick.json"
    path.write_text(json.dumps(cfg))
    assert port_cli.main([str(path), "--device", "cuda"]) == 0
    rep = [json.loads(l) for l in capsys.readouterr().out.splitlines()
           if l.startswith("{")][-1]
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert max(rep["analytic_rel_err"]) < 5e-2


def _stencil_case(device, m, mask_kind):
    """The odd (7, 6, 5) grid's pencil, its PEC mask or an all-ones one
    (zero on the padding rows), and X random on every row."""
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D

    p = StencilPencil3D.build(nx=7, ny=6, nz=5, a=1.0, b=0.8, c=1.3,
                              dtype=torch.float32, device=device)
    mask = p.mask
    if mask_kind == "ones":
        mask = torch.zeros_like(p.mask)
        mask[: p.n] = 1.0
    X = torch.from_numpy(
        np.random.default_rng(m).standard_normal((p.n_padded, m))
    ).float().to(device)
    return p, mask, X


def _check_stencil(p, got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            err = (g - w).abs().max() / w.abs().max()
            assert err.item() <= 1e-5
            assert not g[p.n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["pec", "ones"])
@pytest.mark.parametrize("mode", ["K", "M", "KM"])
@pytest.mark.parametrize("m", [1, 3, 9, 17, 86, 171, 256, 341])
def test_cuda_stencil_kernel_matches_plain(cuda_device, m, mode, mask_kind):
    """An odd (7, 6, 5) grid: the three component grids have different
    shapes, so the staging of every grid's edges is exercised (m 86: six
    z tiles, two staged elements a thread; m 171, 256, 341: two or three
    column passes, each launch in place at X's row stride). X is random on
    masked and padding rows too: the kernel applies both masks, which are
    data (the PEC mask, or all ones)."""
    p, mask, X = _stencil_case(cuda_device, m, mask_kind)
    want_K, want_M = mode != "M", mode != "K"
    kst.reset_counts()
    got = kst.stencil_taps(X, mask, p.taps, p.shape, want_K, want_M)
    want = kst.stencil_taps_ref(X, mask, p.taps, p.shape, want_K, want_M)
    assert kst.counts() == {"stencil_taps": len(kst.column_passes(m)),
                            "stencil_taps_ref": 1}
    _check_stencil(p, got, want)


@pytest.mark.cuda
def test_cuda_stencil_slice_matches_cpu_plain(cuda_device):
    """The 8^3 road to 1e-8 (f32 LOBPCG with the spectral preconditioner,
    then refine_dw) through the kernel on the card, against the same road
    through its plain version on the CPU."""
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
    from maxwell_tpu_torch.solvers.lobpcg import lobpcg
    from maxwell_tpu_torch.solvers.refine_device import refine_dw
    from maxwell_tpu_torch.solvers.spectral import spectral_preconditioner

    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = StencilPencil3D.build(nx=8, ny=8, nz=8, dtype=torch.float32,
                                  device=dev)
        X0 = np.zeros((p.n_padded, 9), np.float32)
        X0[: p.n] = np.random.default_rng(3).standard_normal((p.n, 9))
        kst.reset_counts()
        r32 = lobpcg(p, nev=5, maxiter=60, tol=1e-5, stall_window=10,
                     precond=spectral_preconditioner(p, 15.0), X0=X0)
        out[dev.type] = (refine_dw(p, r32.eigenvectors, tol=1e-8),
                         kst.counts())
    (gpu, gpu_counts), (cpu, _) = out["cuda"], out["cpu"]
    assert gpu.converged and gpu.residuals.max() <= 1e-8
    np.testing.assert_allclose(gpu.eigenvalues, cpu.eigenvalues, rtol=1e-9)
    assert gpu_counts["stencil_taps"] > 0
    assert gpu_counts["stencil_taps_ref"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 9, 171])
@pytest.mark.parametrize("mode", ["K", "M", "KM"])
def test_cuda_dist_stencil_k4_route_matches_plain(cuda_device, m, mode):
    """The slab-sharded tap apply on the card: K4 on each slab's
    ghost-extended block (a (cells + 2, ny, nz) brick; m 171 in two column
    passes) against the plain slab apply on the same card, within 1e-5 of
    max|plain|; one launch per slab and pass, no plain call."""
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D

    p = DistStencilPencil3D.build(nx=16, ny=7, nz=5, D=4,
                                  dtype=torch.float32, device=cuda_device)
    X = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (p.global_rows, m)).astype(np.float32)).to(cuda_device)
    want_K, want_M = mode != "M", mode != "K"
    kst.reset_counts()
    got = p._taps_apply_slab(X, want_K, want_M)
    assert kst.counts() == {"stencil_taps": p.D * len(kst.column_passes(m)),
                            "stencil_taps_ref": 0}
    want = p._taps_apply_plain(X, want_K, want_M)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            err = (g - w).abs().max() / w.abs().max()
            assert err.item() <= 1e-5


@pytest.mark.cuda
def test_cuda_dist_stencil_slice_matches_cpu_plain(cuda_device):
    """The 16^3 slab road to 1e-8 in 8 slabs (f32 lobpcg_dist with the
    distributed spectral preconditioner, then refine_dw_dist) through K4
    on the card, against the same road through the plain slab apply on
    the CPU; the card's path launched K4."""
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
    from maxwell_tpu_torch.solvers.refine_device import refine_dw_dist

    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = DistStencilPencil3D.build(nx=16, ny=16, nz=16, D=8,
                                      dtype=torch.float32, device=dev)
        X0 = p.inject_vectors(np.random.default_rng(3).standard_normal(
            (p.n_full, 8)))
        kst.reset_counts()
        r32 = lobpcg_dist(p, None, nev=4, maxiter=60, tol=1e-5,
                          stall_window=10, X0=X0)
        out[dev.type] = (refine_dw_dist(p, None, r32.eigenvectors, tol=1e-8),
                         kst.counts())
    (gpu, gpu_counts), (cpu, _) = out["cuda"], out["cpu"]
    assert gpu.converged and gpu.residuals.max() <= 1e-8
    np.testing.assert_allclose(gpu.eigenvalues, cpu.eigenvalues, rtol=1e-9)
    assert gpu_counts["stencil_taps"] > 0
    assert gpu_counts["stencil_taps_ref"] == 0


@pytest.mark.cuda
def test_cuda_dist_stencil_f64_takes_the_plain_apply(cuda_device):
    """An f64 slab pencil on the card applies by the plain version (the
    tap kernel is f32): no launch, the CPU's result."""
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D

    p = DistStencilPencil3D.build(nx=8, ny=5, nz=4, D=4,
                                  dtype=torch.float64, device=cuda_device)
    q = DistStencilPencil3D.build(nx=8, ny=5, nz=4, D=4,
                                  dtype=torch.float64, device="cpu")
    X = q.make_block(3)
    kst.reset_counts()
    K, M = p.KM_mm(X.to(cuda_device))
    assert kst.counts() == {"stencil_taps": 0, "stencil_taps_ref": 0}
    Kc, Mc = q.KM_mm(X)
    torch.testing.assert_close(K.cpu(), Kc, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(M.cpu(), Mc, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_cuda_cli_config4_stencil(cuda_device, capsys, tmp_path):
    """configs/config4_stencil.json (f64, 8 slabs, refine) at 16^3 through
    the CLI on the card."""
    with open(os.path.join(CONFIGS, "config4_stencil.json")) as f:
        cfg = json.load(f)
    cfg["problem"].update(nx=16, ny=16, nz=16)
    path = tmp_path / "config4_stencil_16.json"
    path.write_text(json.dumps(cfg))
    assert port_cli.main([str(path), "--device", "cuda"]) == 0
    rep = [json.loads(l) for l in capsys.readouterr().out.splitlines()
           if l.startswith("{")][-1]
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8


@pytest.mark.cuda
def test_cuda_cli_config7(cuda_device, capsys, tmp_path):
    """configs/config7_dielectric.json (loaded cavity, field taps, on-device
    dw refinement) at 8^3 through the CLI on the card."""
    with open(os.path.join(CONFIGS, "config7_dielectric.json")) as f:
        cfg = json.load(f)
    cfg["problem"].update(nx=8, ny=8, nz=8)
    path = tmp_path / "config7_8.json"
    path.write_text(json.dumps(cfg))
    assert port_cli.main([str(path), "--device", "cuda"]) == 0
    rep = [json.loads(l) for l in capsys.readouterr().out.splitlines()
           if l.startswith("{")][-1]
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 16, 17, 32, 128])
def test_cuda_bsr_kernels_match_plain(cuda_device, monkeypatch, m, staged):
    """The blocked-ELL SpMM, its windowed form (window staged in shared
    memory, or read from global memory) and the SpMV against their plain
    versions, on both product routes (f32 FMAs at m 1, 2; 3xTF32 mma from
    m 3); the two SpMM forms do the same arithmetic in the same order, and
    the SpMV is the SpMM's m = 1 launch: both bit for bit."""
    cav = PermutedProblem(BrickCavity3D(nx=6, ny=5, nz=4))
    A = BSRMatrix.from_csr(cav.K, block=8, device=cuda_device)
    if not staged:
        monkeypatch.setattr(bsr_spmm, "SMEM_LIMIT", 0)
    assert bsr_spmm.window_staged(A, m) == staged
    X = torch.from_numpy(
        np.random.default_rng(m).standard_normal((A.n_padded, m))
    ).float().to(cuda_device)
    want = bsr_spmm.bsr_matmat_ref(A, X)
    bsr_spmm.reset_counts()
    Y8 = bsr_spmm.bsr_matmat(A, X)
    Y9 = bsr_spmm.bsr_matmat_windowed(A, X)
    got = [Y8, Y9]
    if m == 1:
        got.append(bsr_spmm.bsr_matvec(A, X[:, 0].contiguous())[:, None])
    torch.cuda.synchronize()
    for g in got:
        err = (g - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-5
    assert torch.equal(Y8, Y9)
    if m == 1:
        assert torch.equal(got[2], Y8)
    c = bsr_spmm.counts()
    assert c["bsr_matmat"] == c["bsr_matmat_windowed"] == 1
    assert c["bsr_matvec"] == (m == 1)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [129, 200, 300])
def test_cuda_bsr_wide_x_in_passes(cuda_device, m):
    """Past 128 columns the SpMM launches once per 128 columns (the last
    pass narrower), the windowed form staging each pass's columns of the
    window."""
    cav = PermutedProblem(BrickCavity3D(nx=6, ny=5, nz=4))
    A = BSRMatrix.from_csr(cav.K, block=8, device=cuda_device)
    X = torch.from_numpy(
        np.random.default_rng(m).standard_normal((A.n_padded, m))
    ).float().to(cuda_device)
    want = bsr_spmm.bsr_matmat_ref(A, X)
    Y8 = bsr_spmm.bsr_matmat(A, X)
    Y9 = bsr_spmm.bsr_matmat_windowed(A, X)
    torch.cuda.synchronize()
    assert ((Y8 - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert torch.equal(Y8, Y9)
    # a pass equals the same columns taken alone (on the mma route there)
    if m - 128 >= 3:
        assert torch.equal(Y8[:, 128:], bsr_spmm.bsr_matmat(
            A, X[:, 128:].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["f64", "misaligned"])
def test_cuda_bsr_wrappers_raise(cuda_device, bad):
    """No fallback: an f64 CUDA tensor or a layout not cut into whole
    128-row tiles raises instead of taking the plain version."""
    cav = PermutedProblem(BrickCavity3D(nx=6, ny=5, nz=4))
    dtype = torch.float64 if bad == "f64" else torch.float32
    A = BSRMatrix.from_csr(cav.K, block=8, dtype=dtype, device=cuda_device,
                           row_align=1 if bad == "misaligned" else None)
    X = torch.ones((A.n_padded, 2), dtype=dtype, device=cuda_device)
    for fn in (bsr_spmm.bsr_matmat, bsr_spmm.bsr_matmat_windowed):
        with pytest.raises(ValueError):
            fn(A, X)
    with pytest.raises(ValueError):
        bsr_spmm.bsr_matvec(A, X[:, 0].contiguous())


@pytest.mark.cuda
def test_cuda_pallas_solve_matches_cpu_plain(cuda_device):
    """The f32 "pallas" solve through the blocked-ELL kernels on the card
    against the same solve through their plain versions on the CPU, both
    refined to 1e-8."""
    prob = PermutedProblem(BrickCavity3D(nx=6, ny=6, nz=6))
    X0 = np.random.default_rng(2).standard_normal((prob.K.shape[0], 9))
    opts = dict(nev=5, tol=1e-8, dtype=torch.float32, kernel="pallas",
                stall_window=12, X0=X0)
    bsr_spmm.reset_counts()
    spmm.reset_counts()
    got = maxwell_tpu_torch.solve(prob, device=cuda_device, **opts)
    counts = {**bsr_spmm.counts(), **spmm.counts()}
    want = maxwell_tpu_torch.solve(prob, device="cpu", **opts)
    assert got.converged and got.residuals.max() <= 1e-8
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-7)
    assert counts["bsr_matmat"] > 0 and counts["bsr_matmat_ref"] == 0
    assert counts["bellunion_km_matmat"] == counts["bellunion_matmat"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lanczos", "tr_lanczos"])
def test_cuda_cli_config1_pallas(cuda_device, capsys, tmp_path, kind):
    """config 1 through the CLI on the card: f32 "pallas" Krylov solve
    through the blocked-ELL SpMV, host f64 refine to 1e-8."""
    with open(os.path.join(CONFIGS, "config1.json")) as f:
        cfg = json.load(f)
    cfg["storage"] = {"dtype": "f32", "kernel": "pallas"}
    cfg["solver"].update(kind=kind, refine=True, ncv=24, max_restarts=60)
    path = tmp_path / "config1_pallas.json"
    path.write_text(json.dumps(cfg))
    bsr_spmm.reset_counts()
    assert port_cli.main([str(path), "--device", "cuda"]) == 0
    counts = bsr_spmm.counts()
    rep = [json.loads(l) for l in capsys.readouterr().out.splitlines()
           if l.startswith("{")][-1]
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert counts["bsr_matvec"] > 0 and counts["bsr_matvec_ref"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("m", [1, 2, 3, 9, 16, 17, 33])
@pytest.mark.parametrize("grid", [(6, 5, 4), (8, 8, 8)])
def test_cuda_bellpairs_kernels_match_plain(cuda_device, monkeypatch, grid,
                                            m, staged):
    """The BELLPairs SpMM (both streams), the fused K/M SpMM, the windowed
    SpMM (window staged in shared memory, or read from global memory) and
    the banded forms (1 band on 6x5x4, 4 on 8^3) against their plain
    versions; the one-stream, fused, windowed and banded forms do the same
    per-element arithmetic in the same order."""
    cav = PermutedProblem(BrickCavity3D(nx=grid[0], ny=grid[1], nz=grid[2]))
    A = BELLPairs.from_csr(cav.K, B=cav.M, device=cuda_device)
    AB = A.banded(m=8, budget_bytes=24 * 1024)
    if not staged:
        monkeypatch.setattr(bsr_spmm, "SMEM_LIMIT", 0)
    assert kp.window_staged(A, m) == staged
    X = torch.from_numpy(
        np.random.default_rng(m).standard_normal((A.n_padded, m))
    ).float().to(cuda_device)
    want_k, want_m = kp.bellpairs_km_matmat_ref(A, X)
    kp.reset_counts()
    Yk, Ym = kp.bellpairs_km_matmat(A, X)
    got = {
        "a": (kp.bellpairs_matmat(A, X, "a"), want_k),
        "b": (kp.bellpairs_matmat(A, X, "b"), want_m),
        "km_k": (Yk, want_k), "km_m": (Ym, want_m),
        "windowed": (kp.bellpairs_matmat_windowed(A, X), want_k),
        "banded_b": (kp.bellpairs_matmat_banded(AB, X, "b"), want_m),
    }
    Bk, Bm = kp.bellpairs_km_matmat_banded(AB, X)
    got.update(banded_km_k=(Bk, want_k), banded_km_m=(Bm, want_m))
    torch.cuda.synchronize()
    for name, (g, w) in got.items():
        err = (g - w).abs().max() / w.abs().max()
        assert err.item() <= 1e-5, name
    for name in ("km_k", "windowed", "banded_km_k"):
        assert torch.equal(got[name][0], got["a"][0]), name
    for name in ("km_m", "banded_b", "banded_km_m"):
        assert torch.equal(got[name][0], got["b"][0]), name
    c = kp.counts()
    assert (c["bellpairs_matmat"], c["bellpairs_km_matmat"],
            c["bellpairs_matmat_windowed"], c["bellpairs_matmat_banded"],
            c["bellpairs_km_matmat_banded"]) == (2, 1, 1, 1, 1)
    assert not any(c[fn.__name__] for fn in kp.PLAIN)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [129, 200])
def test_cuda_bellpairs_wide_x_in_passes(cuda_device, m):
    """Past 128 columns the BELLPairs kernels launch once per 128 columns
    (the last pass narrower), the fused form writing both outputs of each
    pass, the windowed form staging each pass's columns of the window."""
    cav = PermutedProblem(BrickCavity3D(nx=6, ny=5, nz=4))
    A = BELLPairs.from_csr(cav.K, B=cav.M, device=cuda_device)
    X = torch.from_numpy(
        np.random.default_rng(m).standard_normal((A.n_padded, m))
    ).float().to(cuda_device)
    want_k, want_m = kp.bellpairs_km_matmat_ref(A, X)
    Yk, Ym = kp.bellpairs_km_matmat(A, X)
    Ya = kp.bellpairs_matmat(A, X, "a")
    Yw = kp.bellpairs_matmat_windowed(A, X)
    torch.cuda.synchronize()
    for got, want in ((Yk, want_k), (Ym, want_m)):
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert torch.equal(Yk, Ya) and torch.equal(Yw, Ya)
    # a pass equals the same columns taken alone (on the mma route there)
    if m - 128 >= 3:
        assert torch.equal(Ya[:, 128:], kp.bellpairs_matmat(
            A, X[:, 128:].contiguous(), "a"))


@pytest.mark.cuda
def test_cuda_bellpairs_wrappers_raise(cuda_device):
    """No fallback: an f64 CUDA tensor raises instead of taking the plain
    version."""
    cav = PermutedProblem(BrickCavity3D(nx=6, ny=5, nz=4))
    A = BELLPairs.from_csr(cav.K, B=cav.M, dtype=torch.float64,
                           device=cuda_device)
    X = torch.ones((A.n_padded, 2), dtype=torch.float64, device=cuda_device)
    for call in (lambda: kp.bellpairs_matmat(A, X, "b"),
                 lambda: kp.bellpairs_km_matmat(A, X),
                 lambda: kp.bellpairs_matmat_windowed(A, X)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.cuda
def test_cuda_bellpairs_solve_matches_cpu_plain(cuda_device):
    """The f32 "bellpairs" solve through its kernels on the card against the
    same solve through their plain versions on the CPU, both refined to
    1e-8."""
    prob = PermutedProblem(BrickCavity3D(nx=6, ny=6, nz=6))
    X0 = np.random.default_rng(2).standard_normal((prob.K.shape[0], 9))
    opts = dict(nev=5, tol=1e-8, dtype=torch.float32, kernel="bellpairs",
                stall_window=12, X0=X0)
    kp.reset_counts()
    got = maxwell_tpu_torch.solve(prob, device=cuda_device, **opts)
    counts = kp.counts()
    want = maxwell_tpu_torch.solve(prob, device="cpu", **opts)
    assert got.converged and got.residuals.max() <= 1e-8
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-7)
    assert counts["bellpairs_km_matmat"] > 0 and counts["bellpairs_matmat"] > 0
    assert not any(counts[fn.__name__] for fn in kp.PLAIN)


@pytest.mark.cuda
def test_cuda_cli_config2_bellpairs(cuda_device, capsys, tmp_path):
    """Config 2 through the CLI on the card with `storage.kernel:
    "bellpairs"` at f32 and the host f64 refine to 1e-8."""
    with open(os.path.join(CONFIGS, "config2.json")) as f:
        cfg = json.load(f)
    cfg["storage"] = {"dtype": "f32", "kernel": "bellpairs"}
    path = tmp_path / "config2_bellpairs.json"
    path.write_text(json.dumps(cfg))
    kp.reset_counts()
    assert port_cli.main([str(path), "--device", "cuda", "--refine"]) == 0
    counts = kp.counts()
    rep = [json.loads(l) for l in capsys.readouterr().out.splitlines()
           if l.startswith("{")][-1]
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert counts["bellpairs_km_matmat"] > 0
    assert counts["bellpairs_km_matmat_ref"] == 0


def _dist(kernel, impl, device, problem=None):
    return partition_problem(problem or RectCavity2D(nx=16, ny=16), 8,
                             kernel=kernel, dtype=torch.float32,
                             halo_impl=impl, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 3, 9])
@pytest.mark.parametrize("depth", ["0", "1", "16", "Lb", "deep"])
@pytest.mark.parametrize("Lb", [5, 40])
@pytest.mark.parametrize("D", [1, 2, 8])
def test_cuda_ring_shift_matches_plain(cuda_device, D, Lb, depth, m, dtype):
    """The ring-shift kernel (K6) equals its plain version bit for bit, in
    both output layouts, at every copy unit it chooses: odd and even shard
    lengths, 4- to 72-byte rows, no halo, a one-row halo, 16 rows, a halo
    as deep as a shard and one deeper, one, two and eight shards, and X at
    an address that only 4 (f32) or 8 (f64) divides."""
    Hb = {"0": 0, "1": 1, "16": 16, "Lb": Lb, "deep": Lb + 16}[depth]
    base = torch.from_numpy(np.random.default_rng(D + m).standard_normal(
        D * Lb * m + 1)).to(dtype=dtype, device=cuda_device)
    halo.reset_counts()
    for X in (base[:-1].view(D * Lb, m), base[1:].view(D * Lb, m)):
        for own, pad in ((False, 0), (True, 8)):
            got = halo.ring_shift(X, D, Hb, own, pad)
            want = halo.ring_shift_ref(X, D, Hb, own, pad)
            assert torch.equal(got, want)
    assert halo.counts()["ring_shift"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("streams", ["a", "b", "ab"])
@pytest.mark.parametrize("m", [1, 9, 17])
def test_cuda_union_overlap_matches_plain(cuda_device, streams, m):
    """The fused interior SpMM + halo copy (K5): bit for bit the one-stream
    kernel (K2) and the ring shift, and within the union bound of its plain
    version."""
    dp = _dist("union", "rdma_overlap", cuda_device)
    X = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (dp.global_rows, m))).float().to(cuda_device)
    got = halo.union_interior_overlap(dp.Ui, X, dp.D, dp.Hb, streams)
    want = [spmm.bellunion_matmat(dp.Ui, X, s) for s in streams]
    want.append(halo.ring_shift(X, dp.D, dp.Hb))
    plain = halo.union_interior_overlap_ref(dp.Ui, X, dp.D, dp.Hb, streams)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
        assert (g - p).abs().max().item() <= TOL["highest"] * p.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "b3"])
def test_cuda_union_banded_matches_plain(cuda_device, precision):
    """The banded union apply (K7): bit for bit the full-X kernel (K2),
    within the union bound of its plain version."""
    cav = PermutedProblem(BrickCavity3D(nx=12, ny=12, nz=12))
    A = BELLUnion.from_csr(cav.K, B=cav.M, device=cuda_device).bf16x3()
    AB = A.banded(9, budget_bytes=4 * 9 * 3000, split_bf16=True)
    assert len(AB.bands) > 1
    X = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (A.n_padded, 9))).float().to(cuda_device)
    spmm.reset_counts()
    for stream in "ab":
        got = spmm.bellunion_matmat_banded(AB, X, stream, precision)
        assert torch.equal(got, spmm.bellunion_matmat(A, X, stream,
                                                      precision))
        want = spmm.bellunion_matmat_banded_ref(AB, X, stream, precision)
        assert ((got - want).abs().max() / want.abs().max()).item() <= TOL[
            precision]
    assert spmm.counts()["bellunion_matmat_banded"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,impl", [("union", "rdma_overlap"),
                                         ("pallas", "rdma")])
def test_cuda_dist_transports_bit_equal_ppermute(cuda_device, kernel, impl):
    base = _dist(kernel, "ppermute", cuda_device)
    port = _dist(kernel, impl, cuda_device)
    X = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (base.global_rows, 9))).float().to(cuda_device)
    for a, b in zip(port.KM_mm(X), base.KM_mm(X)):
        assert torch.equal(a, b)
    assert torch.equal(port.M_mm(X[:, 0]), base.M_mm(X[:, 0]))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,impl", [("union", "rdma_overlap"),
                                         ("pallas", "rdma")])
def test_cuda_dist_solve_matches_cpu_plain(cuda_device, kernel, impl):
    """The distributed f32 LOBPCG through the kernels on the card against
    the same solve through their plain versions on the CPU, held to 1e-5.
    With the small SVQB/Rayleigh-Ritz eigh in f32 this 480-row problem
    stalled near 1-2e-5 on the card (cuSOLVER's f32 eigh leaves 2.6-3.5x
    LAPACK's eigen-residual) where the CPU reached 5e-6; solvers/rr.small_eigh
    runs that eigh in f64 on the tensor's device, and the card's run then
    converges below 1e-5 like the CPU's (PERF.md section 7)."""
    X0 = np.random.default_rng(7).standard_normal((480, 7))
    opts = dict(nev=3, maxiter=60, tol=1e-5, precond_alpha=10.0, X0=X0,
                stall_window=8)
    halo.reset_counts()
    bsr_spmm.reset_counts()
    got = lobpcg_dist(_dist(kernel, impl, cuda_device), **opts)
    counts = {**halo.counts(), **bsr_spmm.counts()}
    want = lobpcg_dist(_dist(kernel, impl, "cpu"), **opts)
    assert want.converged and got.residuals.max() <= 1e-5
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=2e-5)
    if kernel == "union":
        assert counts["union_interior_overlap"] > 0
    else:
        assert counts["ring_shift"] > 0 and counts["bsr_matmat"] > 0
    assert not any(counts[fn.__name__] for fn in halo.PLAIN)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
def test_cuda_cross_process_halo_kernels_match_peer_copy(cuda_device, P):
    """K6 and K5 across P processes sharing the card (dist/procs.py), each
    pushing its boundary rows into its neighbours' IPC-mapped buffers:
    exchange_bench raises unless on every rank each kernel equals the
    peer-copy transport, and K5's products K2, bit for bit; the gathered
    halos and products equal the one-process pencil's bit for bit."""
    from maxwell_tpu_torch.dist import procs, rank_tasks

    spec = ("rect", 16)
    one = rank_tasks.exchange_bench(spec, 8, 1, reps=2)
    got = procs.spawn(rank_tasks.exchange_bench, P, spec, 8, P, (9, 1), 0,
                      2, device=cuda_device)
    assert set(got["outputs"]) == set(one["outputs"])
    for key, want in one["outputs"].items():
        assert np.array_equal(got["outputs"][key], want), key


def _host_routes(hosts, per_host):
    """Each rank's routes with hosts-major ranks: "ipc" to a neighbour on
    its host, "host_staged" to one on another, None at a chain end."""
    P = hosts * per_host

    def route(r, q):
        if not 0 <= q < P:
            return None
        return "ipc" if q // per_host == r // per_host else "host_staged"

    return [{"left": route(r, r - 1), "right": route(r, r + 1)}
            for r in range(P)]


@pytest.mark.cuda
@pytest.mark.parametrize("hosts,per_host", [(2, 1), (2, 2)])
def test_cuda_halo_kernels_across_hosts_match_one_process(cuda_device, hosts,
                                                          per_host):
    """K6 and K5 (both streams) and the slab pencil's ghost exchange with
    K4 across two host launchers (dist/procs.py run_hosts: a TCPStore on
    127.0.0.1), 1 or 2 ranks each on the card. A side to the other host
    takes the host-staged route (the kernels' push flag off there), a
    side on the host the IPC push; at 2 x 2 the ranks at the host
    boundary have one of each. Every side reports its route and counts
    its bytes as on the host or across hosts. exchange_bench raises
    unless on every rank each kernel equals the plain transport and K5's
    products K2, and slab_bench unless K4 is within 1e-5 of the plain
    slab apply, on every rank; the gathered halos, products, ghost blocks
    and K4 outputs equal the one-process pencil's bit for bit."""
    from maxwell_tpu_torch.dist import procs, rank_tasks

    spec, grid, P = ("rect", 16), 16, hosts * per_host
    one = rank_tasks.exchange_bench(spec, 8, 1, reps=2)
    one_slabs = rank_tasks.slab_bench(grid, 8, 1, (9,), 0, 2)
    got, slabs = procs.run_hosts(
        rank_tasks.sequence, hosts, per_host,
        [(rank_tasks.exchange_bench, (spec, 8, P, (9, 1), 0, 2)),
         (rank_tasks.slab_bench, (grid, 8, P, (9,), 0, 2))],
        device=cuda_device)
    for want_all, got_all in ((one, got), (one_slabs, slabs)):
        assert set(got_all["outputs"]) == set(want_all["outputs"])
        for key, want in want_all["outputs"].items():
            assert np.array_equal(got_all["outputs"][key], want), key
    want_routes = _host_routes(hosts, per_host)
    for name, sides in ([(row["kernel"], row["sides"]) for row in got["rows"]]
                        + [("slabs", slabs["rows"][0]["sides_per_rank"])]):
        assert [s["routes"] for s in sides] == want_routes, name
        for s in sides:
            routes = list(s["routes"].values())
            assert (s["bytes_pushed"] > 0) == ("ipc" in routes), name
            assert (s["bytes_across_hosts"] > 0) == (
                "host_staged" in routes), name
    for c in got["counts"]:
        assert c["ring_shift"] > 0 and c["union_interior_overlap"] > 0
    assert all(n > 0 for n in slabs["rows"][0]["launches_per_apply_per_rank"])


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
def test_cuda_k5_on_a_padding_rank_matches_plain(cuda_device, P):
    """F5: K5 (both streams) across P processes on the 16x16 rectangle's
    8 union shards, whose shards 4-7 hold only padding rows: on every rank
    within 1e-5 of max|plain| of the plain version (so exactly zero on a
    rank of padding rows, where a second stream was once left unwritten),
    the halo section bit for bit the plain transport's; the gathered
    outputs bit for bit one process's."""
    from maxwell_tpu_torch.dist import procs, rank_tasks

    spec = ("rect", 16)
    one = rank_tasks.padding_rank_overlap(spec, 8, 1, cuda_device)
    got = procs.spawn(rank_tasks.padding_rank_overlap, P, spec, 8, P,
                      cuda_device, device=cuda_device)
    for m, ranks in got["ranks"].items():
        assert [r["padding_only"] for r in ranks] == [
            r >= P // 2 for r in range(P)]
        for r in ranks:
            assert r["err_a"] <= 1e-5 * r["scale"]
            assert r["err_b"] <= 1e-5 * r["scale"]
            assert r["halo_equal"]
        for a, b in zip(got["outputs"][m], one["outputs"][m]):
            assert np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
def test_cuda_cross_process_slab_ghosts_and_k4_match_one_process(
        cuda_device, P):
    """The slab pencil across P processes sharing the card: each rank's
    ghost-extended blocks, its neighbours' edge planes pushed into them
    (peer copies between the link's fences), and K4 on each of its blocks;
    slab_bench raises unless on every rank K4 is within 1e-5 of max|plain|
    of the plain slab apply; the gathered blocks and K4 outputs equal the
    one-process pencil's bit for bit."""
    from maxwell_tpu_torch.dist import procs, rank_tasks

    one = rank_tasks.slab_bench(16, 8, 1, (9, 1), 0, 2)
    got = procs.spawn(rank_tasks.slab_bench, P, 16, 8, P, (9, 1), 0, 2,
                      device=cuda_device)
    assert set(got["outputs"]) == set(one["outputs"])
    for key, want in one["outputs"].items():
        assert np.array_equal(got["outputs"][key], want), key
    for row in got["rows"]:
        assert all(n == 8 // P for n in row["launches_per_apply_per_rank"])


@pytest.mark.cuda
@pytest.mark.parametrize("T,UC", [(10, 16), (37, 32), (300, 16), (900, 16)])
def test_cuda_union_panel_kernels_match_plain(cuda_device, T, UC):
    """K15a's kernels against their plain versions on the probe's own
    inputs (T > 8 and not a multiple of 8; T 300 not a multiple of the SM
    count; at T 900 more 16-row units than the persistent grid has warps,
    so warps walk several units and blocks several tiles): 1e-5 of
    max|plain| (u0_def: against the plain product of bf16-rounded
    operands), rows from 128 T on zero, and two launches bit for bit
    equal (each output written once by one thread)."""
    d = exp_union.make_inputs(T, UC)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in d.items()
         if k != "n"}
    cols, rcols, vals, vb, X = (t[k] for k in ("cols", "rcols", "vals",
                                               "vals_b", "X"))
    up.reset_counts()
    cases = [
        (lambda: up.u0_hi(cols, vals, X), up.panel_plain(cols, vals, X, 8)),
        (lambda: up.u0_def(cols, vals, X),
         up.panel_plain(cols, vals, X, 8, bf16=True)),
        (lambda: up.u1_runs(rcols, vals, X),
         up.panel_plain(rcols, vals, X, 64)),
        (lambda: up.u2_km(rcols, vals, vb, X),
         up.panel_plain(rcols, vals, X, 64, vals_b=vb)),
    ]
    for call, want in cases:
        got, again = call(), call()
        torch.cuda.synchronize()
        assert got.shape == X.shape
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
        assert not got[128 * T:].any()
        assert torch.equal(got, again)
    c = up.counts()
    assert all(c[fn.__name__] == 2 for fn in up.KERNELS[:4])
    assert not any(c[fn.__name__] for fn in up.PLAIN)
    for kind in ("f32", "f32_fused", "bf16"):
        shape = up.panel_launch_shape(T, 8 * UC, kind)
        assert shape["blocks_per_sm"] >= 1 and shape["smem"] > 0
        if T == 900:
            assert 8 * T > shape["grid"] * shape["warps"], (kind, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("cl,pack", [(512, 1), (1024, 1), (1024, 2),
                                     (1024, 4), (512, 2), (128, 1)])
@pytest.mark.parametrize("m", [1, 8, 9, 17, 33])
def test_cuda_union_unstaged_matches_plain(cuda_device, cl, pack, m):
    """K15b's unstaged kernel against its plain version (1e-5 of
    max|plain|), bit for bit against K2 "highest" on the same layout (the
    same walk of the live form in the same order of operations; at m 33
    five 8-column passes, the last one ragged), and bit for bit itself over
    two launches (one warp walks a row group's chunks in order: no
    atomics)."""
    cav = PermutedProblem(BrickCavity3D(nx=6, ny=5, nz=4))
    A = BELLUnion.from_csr(cav.K, chunk_lanes=cl, pack=pack,
                           device=cuda_device)
    X = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (A.n_cols_padded, m))).float().to(cuda_device)
    up.reset_counts()
    got, again = up.union_unstaged(A, X), up.union_unstaged(A, X)
    want = up.union_unstaged_ref(A, X)
    staged = spmm.bellunion_matmat(A, X, "a", "highest")
    torch.cuda.synchronize()
    scale = want.abs().max()
    assert ((got - want).abs().max() / scale).item() <= 1e-5
    assert torch.equal(got, staged)
    assert torch.equal(got, again)
    assert up.counts()["union_unstaged"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("T", [10, 37])
@pytest.mark.parametrize("live", [1, 3, 6])
def test_cuda_grid_probes_match_plain(cuda_device, T, live):
    """K15d's six kernels against their plain versions on the probe's own
    draws at small T (> 8, not a multiple of 8), with 1 to 6 live chunks
    and ragged live counts for e2 (0 to 7, clamped at 6): 1e-5 of
    max|plain|; e0-e2 launched once, the gathers e3-e5 twice and bit for
    bit (fixed orders of additions, no atomics), no plain version
    called."""
    d = exp_grid.make_inputs(T)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in d.items()}
    cols, X, vals = t["cols"], t["X"], t["vals"]
    nch = torch.from_numpy(np.random.default_rng(T).integers(
        0, 8, T).astype(np.int32)).to(cuda_device)
    args = {gp.e0_grid1: (X, T), gp.e1_grid6: (X, T),
            gp.e2_grid6_when: (nch, X), gp.e3_acc424: (cols, X, live),
            gp.e4_cat424: (cols, X, live),
            gp.e5_cat424_mm: (cols, vals, X, live)}
    gathers = (gp.e3_acc424, gp.e4_cat424, gp.e5_cat424_mm)
    gp.reset_counts()
    for kern, a in args.items():
        got, want = kern(*a), gp.PLAIN_OF[kern](*a)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (128 * T, 8)
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
        if kern in gathers:
            assert torch.equal(got, kern(*a)), kern.__name__
    c = gp.counts()
    assert all(c[fn.__name__] == (2 if fn in gathers else 1)
               for fn in gp.KERNELS)
    assert not any(c[fn.__name__] for fn in gp.PLAIN)


@pytest.mark.cuda
def test_cuda_e5_all_slots_live(cuda_device):
    """e5 with all 48 slots of every row live (6 chunks) at the probe's T
    298: 1e-5 of max|plain|, and the plan's launch repeated (uncounted)
    equal to the wrapper's bit for bit; one count per wrapper call."""
    d = exp_grid.make_inputs(exp_grid.T_REF)
    cols, X, vals = (torch.from_numpy(d[k]).to(cuda_device)
                     for k in ("cols", "X", "vals"))
    live = gp.NCH
    gp.reset_counts()
    got = gp.e5_cat424_mm(cols, vals, X, live)
    want = gp.cat_mm_plain(cols, vals, X, live)
    torch.cuda.synchronize()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = gp.row_plan(cols.shape[0], live, sms, "cat_mm")
    for _ in range(2):
        assert torch.equal(gp.run_rows(plan, cols, X, vals), got)
    assert gp.counts()["e5_cat424_mm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("grid,m", [(3, 1), (3, 8), (5, 9), (4, 17),
                                    (70, 16), (64, 8)])
def test_cuda_shift_probes_match_plain(cuda_device, grid, m):
    """K15f's seven cases against their plain versions (1e-5 of
    max|plain|), p5 against p1's plain output and p6 against p3's, on the
    probe's own field at small and ragged sizes (ZM = (grid + 2) m from 15
    to 1,152 lanes: one warp, partial warps, rows longer than a block; grid
    3 at m 1 stages its windows in 4-byte copies, 64 at m 8 in 16-byte
    ones); each case launched twice, bit for bit, no plain version
    called."""
    field = torch.from_numpy(exp_stencil2.make_field(grid, m)).to(
        cuda_device)
    plan = spr.field_plan("p3", field, m)
    assert plan.vec == int((grid + 4) * m % 4 == 0)
    spr.reset_counts()
    plain = {c: spr.shift_plain(c, field, m) for c in spr.CASES}
    for case in spr.CASES:
        got, again = spr.shift_probe(case, field, m), \
            spr.shift_probe(case, field, m)
        torch.cuda.synchronize()
        want = plain[exp_stencil2.SAME_AS.get(case, case)]
        assert got.shape == want.shape == (grid + 2, grid + 2,
                                           (grid + 2) * m)
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
        assert ((got - plain[case]).abs().max()
                / plain[case].abs().max()).item() <= 1e-5
        assert torch.equal(got, again), case
    c = spr.counts()
    assert all(c[f"shift_{k}"] == 2 and c[f"shift_{k}_ref"] == 0
               for k in spr.CASES)


@pytest.mark.cuda
def test_cuda_probe_wrappers_raise(cuda_device):
    """Bad device input raises before any launch: f64 or misaligned X, a
    short X, a read block column whose slice leaves X, a cols row count
    not a multiple of 16, an unknown case, m outside [1, 32), a
    non-contiguous field."""
    d = exp_grid.make_inputs(10)
    X = torch.from_numpy(d["X"]).to(cuda_device)
    cols = torch.from_numpy(d["cols"]).to(cuda_device)
    far = cols.clone()
    far[7, 5] = 160  # slice rows 1280-1295 of X's 1288
    field = torch.from_numpy(exp_stencil2.make_field(3, 8)).to(cuda_device)
    gp.reset_counts()
    spr.reset_counts()
    for call in (lambda: gp.e0_grid1(X.double(), 10),
                 lambda: gp.e0_grid1(X.view(-1)[1:-7].view(-1, 8), 10),
                 lambda: gp.e3_acc424(cols, X[:1200], 3),
                 lambda: gp.e3_acc424(cols, X, 7),
                 lambda: gp.e5_cat424_mm(far, torch.from_numpy(
                     d["vals"]).to(cuda_device), X, 3),
                 lambda: gp.e4_cat424(cols[:150].contiguous(), X, 3),
                 lambda: spr.shift_probe("p7", field, 8),
                 lambda: spr.shift_probe("p1", field, 32),
                 lambda: spr.shift_probe("p1", field.transpose(0, 1), 8)):
        with pytest.raises(ValueError):
            call()
    assert not any(gp.counts().values()) and not any(spr.counts().values())


def _spmm_probe_case(case, m, device):
    """(V, cols, X) of a blocked-ELL probe case: a small brick's K (S 32),
    or a random layout of 5 tiles ("random") or of 300 tiles ("many": more
    block rows than 132 SMs x 64 warps) with S = 20 slots, X with 8 rows
    beyond the last block row."""
    if case == "brick":
        cav = PermutedProblem(BrickCavity3D(nx=5, ny=5, nz=6))
        A = BSRMatrix.from_csr(cav.K, block=8, device=device)
        V, cols = spp.panel_values(A.blocks), A.cols
    else:
        rng = np.random.default_rng(7)
        nbr, S = (5 if case == "random" else 300) * 16, 20
        V = torch.from_numpy(rng.standard_normal((nbr * 8, S * 8)).astype(
            np.float32)).to(device)
        cols = torch.from_numpy(rng.integers(0, nbr + 1, (nbr, S)).astype(
            np.int32)).to(device)
    rows = V.shape[0] + 8
    X = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (rows, m)).astype(np.float32)).to(device)
    return V, cols, X


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["brick", "random", "many"])
@pytest.mark.parametrize("m", [8, 32, 64, 128])
def test_cuda_spmm_probes_match_plain(cuda_device, case, m):
    """K15c's eight kernels against their plain versions (1e-5 of
    max|plain|; the _def variants and v3/v3b against the product of
    bf16-rounded operands) at each m, on the 5x5x6 brick's K (3 tiles, S
    32), on a random layout (5 tiles, S 20, X one block row taller than
    the layout) and on one of 300 tiles (more block rows than the card
    holds warps at once); the three _hi variants (3xTF32 mma.sync) and the
    two _def rungs bit for bit across two launches, the others launched
    once; no plain version called."""
    V, cols, X = _spmm_probe_case(case, m, cuda_device)
    hi = ("v1_panel_hi", "v5_batched_hi", "v6_smem_hi", "v2_panel_def",
          "v5_batched_def")
    spp.reset_counts()
    for kern in spp.KERNELS:
        name = kern.__name__
        if name in ("v3_stream", "v3b_onedot"):
            args = (V, X)
        elif name == "v4_gather":
            args = (cols, X)
        else:
            args = (V, cols, X)
        got, want = kern(*args), spp.PLAIN_OF[kern](*args)
        again = kern(*args) if name in hi else got
        torch.cuda.synchronize()
        assert got.shape == want.shape == (V.shape[0], m), name
        assert ((got - want).abs().max()
                / want.abs().max()).item() <= 1e-5, name
        assert torch.equal(got, again), name
    c = spp.counts()
    assert all(c[fn.__name__] == (2 if fn.__name__ in hi else 1)
               for fn in spp.KERNELS)
    assert not any(c[fn.__name__] for fn in spp.PLAIN)


def _union_case(case, m, device):
    """(V, cols, X, S) of 2 tiles for v2_panel_def's extremes. "S52",
    "S64": every unit's 8 S block columns distinct, the largest union an
    8-row unit can have (S 52: 416 entries, a panel of 32 columns within
    232,448 bytes, one block an SM; S 64: 512 entries, passes of 8
    columns). "S68": columns drawn from 200 (passes of 32), 34 steps a
    row, 17 a warp (not a multiple of the 4 value steps in flight)."""
    S = int(case[1:])
    rng = np.random.default_rng(S)
    nbr = 32
    if case == "S68":
        cols = rng.integers(0, 200, (nbr, S))
    else:
        cols = rng.permutation(nbr * S).reshape(nbr, S)
    cols = torch.from_numpy(cols.astype(np.int32)).to(device)
    V = torch.from_numpy(rng.standard_normal((nbr * 8, S * 8)).astype(
        np.float32)).to(device)
    X = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (nbr * S * 8 + 8, m)).astype(np.float32)).to(device)
    return V, cols, X, S


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 32, 64, 128])
@pytest.mark.parametrize("case", ["S52", "S64", "S68"])
def test_cuda_union_def_largest_union(cuda_device, monkeypatch, case, m):
    """v2_panel_def where every unit's union is as large as the unit
    allows (8 S distinct block columns): the largest panel the host plans
    (S 52: 416 entries at 32 columns a pass, 220 KB) and the passes of 8
    (S 64, 512 entries: up to 16 passes), and a row's step halves ragged
    against its value steps in flight (S 68), against the
    plain product of bf16-rounded operands (1e-5 of max|plain|), bit for
    bit across two launches; v5_batched_def beside. With the kernel told
    of a panel one entry smaller than every unit's union, each unit
    writes nothing and the largest union's size is recorded, which the
    wrapper raises."""
    V, cols, X, S = _union_case(case, m, cuda_device)
    largest = spp.largest_union(cols)[0]
    plan = spp.union_plan(largest, S, m, X.shape[0])
    if case != "S68":
        assert largest == 8 * S
    assert plan["pass_width"] == (8 if case == "S64" or m == 8 else 32)
    assert plan["smem"] <= spp.SMEM_LIMIT
    want = spp.product_def_plain(V, cols, X)
    spp.reset_counts()
    for kern in (spp.v2_panel_def, spp.v5_batched_def):
        got, again = kern(V, cols, X), kern(V, cols, X)
        torch.cuda.synchronize()
        assert ((got - want).abs().max()
                / want.abs().max()).item() <= 1e-5, kern.__name__
        assert torch.equal(got, again), kern.__name__
    c = spp.counts()
    assert c["v2_panel_def"] == c["v5_batched_def"] == 2
    assert not c["v2_panel_def_ref"] and not c["v5_batched_def_ref"]
    shape = spp.def_launch_shape("v2", plan["pass_width"], plan["smem"],
                                 plan["passes"])
    assert shape["warps"] == 16 and shape["blocks_per_sm"] >= 1
    status = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    Y = torch.zeros((V.shape[0], m), device=cuda_device)
    short = int(spp.union_sizes(cols).min()) - 1
    scratch = torch.empty((cols.shape[0], S // 2, 32, 2), dtype=torch.int32,
                          device=cuda_device)
    gpr.launch("spmm_union_bf16", V, cols, X, Y, status, scratch,
               cols.shape[0], S, m, X.shape[0], short, 8)
    torch.cuda.synchronize()
    assert int(status.item()) == largest and not Y.any()
    monkeypatch.setattr(spp, "largest_union", lambda c: (short, True))
    with pytest.raises(RuntimeError, match="exceeds"):
        spp.v2_panel_def(V, cols, X)


def _stream_case(tiles, S, m, device):
    """A random value panel of `tiles` 128-row tiles and S slots, and X
    (S 8 + 8 rows, m) from numpy's default_rng."""
    rng = np.random.default_rng(tiles * 1000 + S)
    V = torch.from_numpy(rng.standard_normal((tiles * 128, S * 8)).astype(
        np.float32)).to(device)
    X = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (S * 8 + 8, m)).astype(np.float32)).to(device)
    return V, X


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 32, 64, 128])
@pytest.mark.parametrize("tiles,S", [(3, 32), (300, 20), (298, 64)])
def test_cuda_stream_probes_persistent(cuda_device, tiles, S, m):
    """v3_stream and v3b_onedot, one block per SM walking its units: with
    fewer units than SMs (3 tiles), with more units than SMs x ring stages
    so that every barrier's phase wraps many times (300 tiles at S 20), and
    at the 24^3 K's shape (298 tiles, S 64); each within 1e-5 of max|plain|
    and bit for bit across two runs."""
    V, X = _stream_case(tiles, S, m, cuda_device)
    want = spp.stream_plain(V, X)
    spp.reset_counts()
    for kern in (spp.v3_stream, spp.v3b_onedot):
        got, again = kern(V, X), kern(V, X)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (tiles * 128, m)
        assert ((got - want).abs().max()
                / want.abs().max()).item() <= 1e-5, kern.__name__
        assert torch.equal(got, again), kern.__name__
    c = spp.counts()
    assert c["v3_stream"] == c["v3b_onedot"] == 2
    assert not c["v3_stream_ref"] and not c["v3b_onedot_ref"]


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(10, 64), (37, 20), (300, 64), (298, 64),
                                 (1, 16), (133, 64), (299, 64)])
def test_cuda_gather_probes_match_plain(cuda_device, T, S):
    """K15e's seven kernels against their plain versions on the probe's
    own draws at small T, a ragged S, the probe's T 298 and T 1 (S 16: g2
    and g3 read P = 8 S <= X's 128 T rows), 133, 299, 300 (1e-5 of
    max|plain|; the gathers g2, g3 and g3w bit for bit), and
    g5 bit for bit against K15d's e0; each launched twice, bit for bit
    (gather_sum's ranges cut tiles at every T, and its blocks' slot counts
    lie within one group of 4 of each other), no plain version called."""
    t = {k: torch.from_numpy(v).to(cuda_device)
         for k, v in exp_gather.make_inputs(T, S).items()}
    X = t["X"]
    Xp = torch.nn.functional.pad(X, (0, 0, 0, 8))
    XTp = torch.nn.functional.pad(X.T.contiguous(), (0, 8))
    P = 8 * S
    args = {gpr.g0_slices: (t["cols"], X), gpr.g1_slices2x: (t["cols"], Xp),
            gpr.g4_lane_ds: (t["cols"], XTp), gpr.g2_taa0: (t["idx0"], X, P),
            gpr.g3_taa1: (t["idx1"], X.T.contiguous()),
            gpr.g3w_taa1_wide: (t["idx1w"], t["XTW"], P),
            gpr.g5_floor: (X, T)}
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = gpr.gather_plan(t["cols"], 8, sms)
    assert plan.cut_tiles() > 0 and np.ptp(np.diff(plan.ranges())) <= 4
    gpr.reset_counts()
    gp.reset_counts()
    for kern, a in args.items():
        got, again = kern(*a), kern(*a)
        want = gpr.PLAIN_OF[kern](*a)
        torch.cuda.synchronize()
        assert got.shape == want.shape, kern.__name__
        assert ((got - want).abs().max()
                / want.abs().max()).item() <= 1e-5, kern.__name__
        assert torch.equal(got, again), kern.__name__
        if kern in (gpr.g2_taa0, gpr.g3_taa1, gpr.g3w_taa1_wide):
            assert torch.equal(got, want), kern.__name__
    assert torch.equal(gpr.g5_floor(X, T), gp.e0_grid1(X, T))
    c = gpr.counts()
    assert c["g5_floor"] == 3 and gp.counts()["e0_grid1"] == 1
    assert all(c[fn.__name__] == 2 for fn in gpr.KERNELS[:-1])
    assert not any(c[fn.__name__] for fn in gpr.PLAIN)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["taa0", "taa1"])
@pytest.mark.parametrize("T,P", [(3, gpr.TAA_MAX_P), (5, 3616), (2, 3620),
                                 (7, 12), (298, 512)])
def test_cuda_taa_plans_match_plain(cuda_device, kind, T, P):
    """g2's and g3's kernels bit for bit their plain versions, launched
    twice the same, on the wrappers' plan (the largest P the wrappers take,
    7,264: one block an SM resident, the grid in two rounds; the last P
    with two, 3,616; P 12, units of 4 rows) and, at T 298, on the plans the
    profile times beside it: whole tiles a block, one block per tile, 1 and
    4 blocks an SM; g2 also with output rows lo 4, hi 20 (its rows lo .. lo
    + 7 span two units)."""
    rng = np.random.default_rng(P)
    X = torch.from_numpy(rng.standard_normal((P + 8, 8)).astype(
        np.float32)).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if kind == "taa0":
        idx = torch.from_numpy(rng.integers(0, P, (T * P, 8), dtype=np.int32)
                               ).to(cuda_device)
        src, kern = X, gpr.g2_taa0
        want = gpr.taa0_plain(idx, X, P)
        args = (idx, X, P)
    else:
        idx = torch.from_numpy(rng.integers(0, P, (T * 8, P), dtype=np.int32)
                               ).to(cuda_device)
        src, kern = X.T.contiguous(), gpr.g3_taa1
        want = gpr.taa1_plain(idx, src)
        args = (idx, src)
    gpr.reset_counts()
    got, again = kern(*args), kern(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    assert gpr.counts()[kern.__name__] == 2
    plan = gpr.taa_plan(kind, T, P, sms)
    assert plan.grid == min(gpr.TAA_BLOCKS * sms, plan.units)
    shape = gpr.taa_shape(plan)
    assert shape["local_bytes"] == 0
    assert shape["blocks_per_sm"] >= (2 if P <= 3616 else 1)
    if P != 512:
        return
    tile = plan.tile_rows
    plans = [dataclasses.replace(plan, unit_rows=tile,
                                 grid=min(2 * sms, T)),
             dataclasses.replace(plan, unit_rows=tile, grid=T)]
    plans += [dataclasses.replace(plan, grid=min(k * sms, plan.units))
              for k in (1, 4)]
    for pl in plans:
        Y = torch.full_like(want, float("nan"))
        gpr.run_taa(pl, idx, src, Y)
        torch.cuda.synchronize()
        assert torch.equal(Y, want), pl
    if kind == "taa0":
        g = torch.gather(X[:P], 0, idx.long()).view(T, P, 8)
        Y = torch.empty_like(want)
        gpr.run_taa(plan, idx, X, Y, lo=4, hi=20)
        torch.cuda.synchronize()
        assert torch.equal(Y, (g[:, 4:12] + g[:, 20:28]).reshape(-1, 8))


@pytest.mark.cuda
def test_cuda_chain_ms_times_a_chain(cuda_device):
    """chain_ms times back-to-back launches on the card: an empty launch
    costs less in a chain than alone (median_ms), and a kernel at least
    the chain floor."""
    from maxwell_tpu_torch.bench import timing

    floor = timing.chain_floor_ms()
    assert 0 < floor < timing.launch_floor_ms()
    X = torch.ones((1 << 20, 8), device=cuda_device)
    assert timing.chain_ms(lambda: X.mul_(1.0)) >= floor


@pytest.mark.cuda
def test_cuda_device_ms_times_a_call_of_many_launches(cuda_device):
    """device_ms times one call of 400 small launches on the device alone:
    under the host's enqueue time of the call, and about 400 launches in a
    chain."""
    import time

    from maxwell_tpu_torch.bench import timing

    X = torch.ones((1024, 8), device=cuda_device)

    def call():
        for _ in range(400):
            X.mul_(1.0)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    host_ms = (time.perf_counter() - t0) * 1e3
    ms = timing.device_ms(call)
    assert 0 < ms < host_ms
    assert ms >= 400 * timing.chain_floor_ms() / 2


@pytest.fixture(scope="module")
def brick24_cols():
    """The 24^3 RCM brick K's blocked-ELL cols (v4_gather's layout) and X
    rows, on the CPU."""
    cav = PermutedProblem(BrickCavity3D(nx=24, ny=24, nz=24))
    A = BSRMatrix.from_csr(cav.K, block=8, device="cpu")
    return A.cols, A.n_padded


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 32, 64, 128])
def test_cuda_v4_gather_staged(cuda_device, brick24_cols, m):
    """v4_gather on the 24^3 layout (each tile's 1,024 slots on 124
    distinct slices on average), on the persistent grid of two blocks an
    SM with tiles cut between ranges, agrees with its plain version within
    1e-5 of max|plain|, bit for bit across two launches."""
    cols, rows = brick24_cols
    cols = cols.to(cuda_device)
    X = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (rows, m)).astype(np.float32)).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = gpr.gather_plan(cols, m, sms)
    assert plan.grid == 2 * sms and plan.cut_tiles() > 0
    spp.reset_counts()
    got, again = spp.v4_gather(cols, X), spp.v4_gather(cols, X)
    want = gpr.sum_plain(cols, X)
    torch.cuda.synchronize()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert torch.equal(got, again)
    assert spp.counts()["v4_gather"] == 2 and not spp.counts()[
        "v4_gather_ref"]


@pytest.mark.cuda
def test_cuda_gather_sum_counters_per_stream(cuda_device):
    """gather_sum keeps its cut tiles' counters per stream: launches on a
    side stream and on the current one each get their own buffer, left
    zero, and give the same output bit for bit."""
    t = {k: torch.from_numpy(v).to(cuda_device)
         for k, v in exp_gather.make_inputs(37, 20).items()}
    want = gpr.gather_sum(t["cols"], t["X"])
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        got = gpr.gather_sum(t["cols"], t["X"])
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    mine = [v for (dev, _), v in gpr._COUNTERS.items()
            if dev == t["X"].device]
    assert len(mine) >= 2 and not any(int(v.abs().sum()) for v in mine)


@pytest.mark.cuda
def test_cuda_spmm_and_gather_probe_wrappers_raise(cuda_device):
    """Bad device input raises before any launch: a width the kernels are
    not built for, f64 values, a slot count not a multiple of 4, a block
    column whose slice leaves X, a short X for the fixed panel, a panel
    that with the value ring leaves shared memory (S 96 at m 128), idx out
    of range for g2 and g3, a g2 or g3 panel past 7,264 rows (its staged
    source leaves shared memory), a misaligned or non-contiguous X."""
    V, cols, X = _spmm_probe_case("random", 8, cuda_device)
    far = cols.clone()
    far[3, 7] = X.shape[0] // 8
    t = {k: torch.from_numpy(v).to(cuda_device)
         for k, v in exp_gather.make_inputs(10, 64).items()}
    bad0 = t["idx0"].clone()
    bad0[5, 3] = 512
    bad1 = t["idx1"].clone()
    bad1[2, 9] = -1
    Pbig = gpr.TAA_MAX_P + 4  # the staged source leaves shared memory
    Xbig = torch.zeros((Pbig, 8), device=cuda_device)
    big0 = torch.zeros((Pbig, 8), dtype=torch.int32, device=cuda_device)
    big1 = torch.zeros((8, Pbig), dtype=torch.int32, device=cuda_device)
    wide = torch.zeros((128, 96 * 8), device=cuda_device)  # S 96
    Xwide = torch.zeros((96 * 8, 128), device=cuda_device)
    spp.reset_counts()
    gpr.reset_counts()
    for call in (lambda: spp.v5_batched_hi(V, cols, X[:, :4].contiguous()),
                 lambda: spp.v1_panel_hi(V.double(), cols, X),
                 lambda: spp.v5_batched_def(V[:, :72].contiguous(),
                                            cols[:, :9].contiguous(), X),
                 lambda: spp.v6_smem_hi(V, far, X),
                 lambda: spp.v3_stream(V, X[:100]),
                 lambda: spp.v3b_onedot(wide, Xwide),
                 lambda: spp.v4_gather(cols, X.view(-1)[1:-7].view(-1, 8)),
                 lambda: gpr.g2_taa0(bad0, t["X"], 512),
                 lambda: gpr.g3_taa1(bad1, t["X"].T.contiguous()),
                 lambda: gpr.g2_taa0(big0, Xbig, Pbig),
                 lambda: gpr.g3_taa1(big1, Xbig.T.contiguous()),
                 lambda: gpr.g0_slices(t["cols"], t["X"].T.contiguous().T)):
        with pytest.raises(ValueError):
            call()
    assert not any(spp.counts().values()) and not any(gpr.counts().values())


def _wide_factors(dt, device):
    """A random lower factor of n 20,000 and its reversal (upper) whose
    windows exceed the shared ring at either dtype: row i reads row i - 10
    (levels of ten rows) and two rows further back, the last row the
    first; diagonally dominant, so the f32 solve stays near the f64 one."""
    from maxwell_tpu_torch.kernels import tri_solve

    rng = np.random.default_rng(5)
    n = 20_000
    i = np.arange(10, n)
    far = rng.integers(0, i - 9, size=(2, len(i)))
    rows = np.concatenate([i, i, i, [n - 1]])
    cols = np.concatenate([i - 10, far[0], far[1], [0]])
    vals = np.concatenate([0.5 * rng.uniform(-1, 1, len(i)),
                           0.1 * rng.uniform(-1, 1, 2 * len(i)), [0.1]])
    L = (sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
         + sp.diags(1 + rng.random(n))).tocsr()
    rev = np.arange(n)[::-1]
    U = L[rev][:, rev].tocsr()
    return (tri_solve.LevelSchedule.from_csr(L, True, dt, device),
            tri_solve.LevelSchedule.from_csr(U, False, dt, device))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["ldlt", "splu", "wide"])
def test_cuda_level_solve_matches_plain(cuda_device, kind, dtype, m):
    """level_solve on config 3's factors (16x16, sigma 45; x's window in
    shared memory) and on a random lower and upper factor whose window
    exceeds it (x and the tags in device memory): a backward error within
    the substitution bound (tri_solve.backward_error <= 2); within max(16
    g, 8) eps max|x| of the plain version, g the rounding growth of the
    chain (the f32 plain solve's distance from the f64 one over eps_f32
    max|x|); two runs bit for bit equal, one launch a factor solve; the
    factored solve against scipy."""
    import scipy.sparse.linalg as spla

    from maxwell_tpu_torch.kernels import tri_solve

    cav = RectCavity2D(nx=16, ny=16)
    A = (cav.K - 45.0 * cav.M).tocsc()

    def factor(dt):
        if kind == "wide":
            return None, _wide_factors(dt, cuda_device)
        if kind == "ldlt":
            d = tri_solve.SparseLDLTDevice.factor(A, dtype=dt,
                                                  device=cuda_device)
            return d, (d.L, d.Lt)
        d = tri_solve.SparseLUDevice.from_splu(spla.splu(A), dtype=dt,
                                               device=cuda_device)
        return d, (d.L, d.U)

    dev, factors = factor(dtype)
    _, factors64 = factor(torch.float64)
    _, factors32 = factor(torch.float32)
    rng = np.random.default_rng(m)
    B64 = torch.from_numpy(rng.standard_normal((factors[0].n, m))).to(
        cuda_device)
    B = B64.to(dtype)
    for S, S64, S32 in zip(factors, factors64, factors32):
        assert S.route(dtype) == ("global" if kind == "wide" else "shared")
        tri_solve.reset_counts()
        got = tri_solve.level_solve(S, B)
        again = tri_solve.level_solve(S, B)
        assert tri_solve.counts() == {"level_solve": 2,
                                      "level_solve_plain": 0}
        want = tri_solve.level_solve_plain(S, B)
        p64 = tri_solve.level_solve_plain(S64, B64)
        p32 = tri_solve.level_solve_plain(S32, B64.float())
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        growth = ((p32.double() - p64).abs().max().item()
                  / (torch.finfo(torch.float32).eps * p64.abs().max().item()))
        tol = max(16 * growth, 8) * torch.finfo(dtype).eps * scale
        assert (got - want).abs().max().item() <= tol
        assert tri_solve.backward_error(S, B, got) <= 2
        assert torch.equal(got, again)
    with pytest.raises(ValueError, match="f32 or f64"):
        tri_solve.level_solve(factors[0], B.to(torch.float16))
    with pytest.raises(ValueError, match="factor in"):
        other_dt = torch.float32 if dtype == torch.float64 else torch.float64
        tri_solve.level_solve(factors[0], B.to(other_dt))
    if dev is None:
        return
    x = dev.solve(B).double().cpu().numpy()
    ref = spla.spsolve(A, B64.cpu().numpy()).reshape(x.shape)
    rel = np.abs(x - ref).max() / np.abs(ref).max()
    assert rel <= (1e-10 if dtype == torch.float64 else 1e-3)


@pytest.mark.cuda
def test_cuda_level_chain_and_launch_shape(cuda_device):
    """The hand-off floor probe hands one value on through 1,000 positions
    (out = 1,000) with the solve's 16 warps and with 2; the solve kernel
    builds for both dtypes and routes with no local memory."""
    from maxwell_tpu_torch.kernels import tri_solve

    assert tri_solve.level_chain(1000, cuda_device).item() == 1000.0
    assert tri_solve.level_chain(1000, cuda_device, 2).item() == 1000.0
    for dt in (torch.float32, torch.float64):
        for route in ("shared", "global"):
            shape = tri_solve.launch_shape(dt, route)
            assert shape["registers"] > 0
            assert shape["local_bytes"] == 0


@pytest.mark.cuda
def test_cuda_device_resident_chain_matches_host_chain(cuda_device):
    """lobpcg -> refine_dw with return_device on the 16^3 stencil brick
    (the tap kernel), against the host round trip from the same start: the
    same refined eigenvalues to 1e-12 relative, both to 1e-8."""
    from maxwell_tpu_torch.bench import exp_r5chain

    res = exp_r5chain.run(16, steady=1, device="cuda")
    assert res["host_vs_device_eig_rel"] <= 1e-12
    assert res["converged"] and res["refine_host_res"] <= 1e-8
    assert max(res["residuals_f64_verified"]) <= 2e-8


@pytest.mark.cuda
def test_cuda_two_prod_exact_for_every_broadcast(cuda_device):
    from maxwell_tpu_torch.bench.exp_r4chip import exactness

    out = exactness(cuda_device, np.random.default_rng(7))
    assert len(out["two_prod_err"]) == 5
    assert all(v == 0.0 for v in out["two_prod_err"].values()), out
    assert out["dw_sum_err"] <= 1e-9
