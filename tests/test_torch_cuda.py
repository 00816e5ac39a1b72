"""maxwell_tpu_torch on a CUDA device: the hand-written kernels against
their plain PyTorch versions, and the solve and CLI through them.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. The file imports
neither jax nor maxwell_tpu, so on a machine with the card and no JAX it
runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

import maxwell_tpu_torch
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.kernels import spmm
from maxwell_tpu_torch.problems import BrickCavity3D
from maxwell_tpu_torch.sparse.bellunion import BELLUnion
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
@pytest.mark.parametrize("m", [1, 3, 9, 17])
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
