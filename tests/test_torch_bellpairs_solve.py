"""The BELLPairs road end to end: maxwell_tpu_torch.solve(kernel="bellpairs")
and the CLI's `storage.kernel: "bellpairs"` against maxwell_tpu's solves of
the same problems. The reference's own bellpairs solve needs its Pallas
kernels (interpret mode takes minutes even at 5^3, and its CLI has no
interpret switch), so the port is held to the reference's "ref" road, and
to the dense generalized eigenvalues."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import maxwell_tpu
import maxwell_tpu_torch
from maxwell_tpu.cli import run as ref_cli
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.kernels import bellpairs_spmm as kp
from maxwell_tpu_torch.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu_torch.sparse.reorder import PermutedProblem

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_solve_f32_bellpairs_refined_matches_reference():
    """f32 bellpairs solve (plain versions of the kernels on the CPU), cut
    at the f32 floor and refined to 1e-8 in f64 on the host, against the
    reference's f32 "ref" solve from the same X0, refined the same way."""
    kw = dict(nx=6, ny=6, nz=6)
    ref_prob = RefPermuted(RefBrick(**kw))
    prob = PermutedProblem(BrickCavity3D(**kw))
    n = prob.K.shape[0]
    X0 = np.random.default_rng(2).standard_normal((n, 9))
    X0_ref = np.zeros((-(-n // 128) * 128, 9))
    X0_ref[:n] = X0
    opts = dict(nev=5, tol=1e-8, stall_window=12)
    want = maxwell_tpu.solve(
        ref_prob, dtype=jnp.float32, kernel="ref",
        X0=jnp.asarray(X0_ref, jnp.float32), **opts,
    )
    kp.reset_counts()
    got = maxwell_tpu_torch.solve(
        prob, dtype=torch.float32, kernel="bellpairs", device="cpu", X0=X0,
        **opts,
    )
    counts = kp.counts()
    assert want.converged and got.converged
    assert want.residuals.max() <= 1e-8 and got.residuals.max() <= 1e-8
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-7)
    assert got.eigenvectors.shape == (n, 5)
    # LOBPCG's W apply and the preconditioner's CG go through the fused
    # product, the projector's and the first block's M applies through the
    # one-stream product; on the CPU only their plain versions run
    assert counts["bellpairs_km_matmat_ref"] > 0
    assert counts["bellpairs_matmat_ref"] > 0
    assert not any(counts[fn.__name__] for fn in kp.KERNELS)


def _last_json(out):
    return [json.loads(l) for l in out.strip().splitlines()
            if l.startswith("{")][-1]


def test_cli_config2_bellpairs_matches_reference_cli(capsys, tmp_path):
    """Config 2 cut to 8x8 through the port's CLI with `storage: {"dtype":
    "f32", "kernel": "bellpairs"}` and --refine, against the reference CLI
    on the config as written (f64, kernel "auto" -> "ref")."""
    with open(os.path.join(CONFIGS, "config2.json")) as f:
        cfg = json.load(f)
    cfg["problem"].update(nx=8, ny=8)
    path = tmp_path / "config2_8.json"
    path.write_text(json.dumps(cfg))
    assert ref_cli.main([str(path), "--platform", "cpu"]) == 0
    want = _last_json(capsys.readouterr().out)

    cfg["storage"] = {"dtype": "f32", "kernel": "bellpairs"}
    path = tmp_path / "config2_8_bellpairs.json"
    path.write_text(json.dumps(cfg))
    kp.reset_counts()
    assert port_cli.main([str(path), "--device", "cpu", "--refine"]) == 0
    counts = kp.counts()
    got = _last_json(capsys.readouterr().out)
    assert got["converged"] and max(got["residuals"]) <= 1e-8
    assert got["n"] == want["n"]
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=1e-7)
    assert counts["bellpairs_km_matmat_ref"] > 0


@pytest.mark.parametrize("kernel", ["ref", "bellpairs"])
def test_cli_config2_f32_refine_keeps_the_lowest_modes(capsys, tmp_path,
                                                       kernel):
    """Config 2 as written (32x32) at f32 with the host refine: the f32
    LOBPCG is cut at its floor and hands over its best block, so the refine
    polishes the five lowest modes. Without the cut it bounced at 1-5e-5
    until the block broke down and the refine converged to other
    eigenpairs (lambda ~ 3e3). Held to the dense generalized
    eigenvalues."""
    with open(os.path.join(CONFIGS, "config2.json")) as f:
        cfg = json.load(f)
    p = cfg["problem"]
    cav = RectCavity2D(a=p["a"], b=p["b"], nx=p["nx"], ny=p["ny"])
    dense = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(),
                              eigvals_only=True)
    want = np.sort(dense[dense > 1e-8])[: cfg["solver"]["nev"]]
    cfg["storage"] = {"dtype": "f32", "kernel": kernel}
    path = tmp_path / f"config2_{kernel}.json"
    path.write_text(json.dumps(cfg))
    assert port_cli.main([str(path), "--device", "cpu", "--refine"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got["converged"] and max(got["residuals"]) <= 1e-8
    np.testing.assert_allclose(got["eigenvalues"], want, rtol=1e-8)
