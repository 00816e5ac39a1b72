"""The slice end to end: maxwell_tpu_torch.solve and its CLI against
maxwell_tpu's on the same problems."""

import importlib
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
from maxwell_tpu_torch.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu_torch.solvers import dist_solve
from maxwell_tpu_torch.sparse.reorder import PermutedProblem

torch.set_num_threads(1)

# the module: the package's attribute of that name is the function
lobpcg_mod = importlib.import_module("maxwell_tpu_torch.solvers.lobpcg")

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_solve_f32_union_refined_matches_reference():
    """f32 union solve (plain versions of the kernels on the CPU), cut at
    the f32 floor and refined to 1e-8 in f64 on the host, against the
    reference's f32 "ref" solve refined the same way."""
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
    got = maxwell_tpu_torch.solve(
        prob, dtype=torch.float32, kernel="union", device="cpu", X0=X0,
        **opts,
    )
    assert want.converged and got.converged
    assert want.residuals.max() <= 1e-8 and got.residuals.max() <= 1e-8
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-7)
    assert got.eigenvectors.shape == (n, 5)


def test_solve_auto_kernel_on_cpu_is_ref():
    """kernel="auto" picks the union kernels only on a CUDA device at f32."""
    from maxwell_tpu_torch.kernels import spmm

    spmm.reset_counts()
    res = maxwell_tpu_torch.solve(
        BrickCavity3D(nx=4, ny=4, nz=4), nev=3, tol=1e-8,
        dtype=torch.float32, device="cpu", maxiter=60,
    )
    assert res.converged and res.residuals.max() <= 1e-8
    assert all(v == 0 for v in spmm.counts().values())


@pytest.mark.parametrize(
    "kwargs,match",
    [(dict(solver="shift_invert", sigma=1.0, kernel="bellpairs"), "KM="),
     (dict(distributed=True, solver="shift_invert", sigma=1.0),
      "LOBPCG only")],
)
def test_solve_unported_paths_raise(kwargs, match):
    """What the reference refuses, the port refuses: a shift-invert
    factorization of a bellpairs pencil without the assembled matrices, and
    a distributed shift-invert through solve() (its convenience path is
    LOBPCG only; shift-invert on one device: test_torch_shift_invert.py)."""
    with pytest.raises(ValueError, match=match):
        maxwell_tpu_torch.solve(BrickCavity3D(nx=2, ny=2, nz=2),
                                device="cpu", **kwargs)


def test_solve_distributed_lobpcg():
    """solve(distributed=True): LOBPCG on an 8-shard pencil, refined to
    1e-8 on the host from f32, the same eigenvalues as the one-device
    solve."""
    prob = BrickCavity3D(nx=5, ny=5, nz=5)
    got = maxwell_tpu_torch.solve(prob, nev=3, tol=1e-8, dtype=torch.float32,
                                  distributed=True, n_shards=8,
                                  kernel="union", device="cpu",
                                  stall_window=12)
    want = maxwell_tpu_torch.solve(prob, nev=3, tol=1e-8, device="cpu")
    assert got.converged and got.residuals.max() <= 1e-8
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-8)
    assert {"setup_s", "device_solve_s", "refine_s"} <= set(got.timings)


def test_solve_f32_refine_config2_keeps_the_lowest_modes():
    """Config 2 (32x32) through solve() at f32 with the host refine and no
    stall_window: the f32 LOBPCG is cut at its floor (stall_window 15 by
    default) and hands the refine its best block, so the five lowest modes
    come out. Without the cut the block broke down at the floor and the
    refine converged to a wrong 5th mode. Held to the dense generalized
    eigenvalues at the refine's tolerance."""
    with open(os.path.join(CONFIGS, "config2.json")) as f:
        cfg = json.load(f)
    p, s = cfg["problem"], cfg["solver"]
    cav = RectCavity2D(a=p["a"], b=p["b"], nx=p["nx"], ny=p["ny"])
    dense = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(),
                              eigvals_only=True)
    want = np.sort(dense[dense > 1e-8])[: s["nev"]]
    got = maxwell_tpu_torch.solve(
        cav, nev=s["nev"], tol=s["tol"], maxiter=s["maxiter"],
        precond_alpha=s["precond_alpha"], dtype=torch.float32, refine=True,
        device="cpu")
    assert got.converged and got.residuals.max() <= s["tol"]
    np.testing.assert_allclose(got.eigenvalues, want, rtol=s["tol"])


class _Stop(Exception):
    pass


@pytest.mark.parametrize("distributed", [False, True])
@pytest.mark.parametrize("dtype,refine,given,expect", [
    (torch.float32, True, {}, 15),
    (torch.float32, True, {"stall_window": 0}, 0),
    (torch.float32, True, {"stall_window": 7}, 7),
    (torch.float32, False, {}, None),
    (torch.float64, True, {}, None),
])
def test_solve_stall_window_default(monkeypatch, distributed, dtype, refine,
                                    given, expect):
    """solve() passes LOBPCG stall_window=15 only for an f32 solve that a
    refine follows, and a caller's own value (0 included) wins, on the
    one-device and the distributed branch."""
    seen = {}

    def recording(*args, **kwargs):
        seen.update(kwargs)
        raise _Stop

    mod, name = ((dist_solve, "lobpcg_dist") if distributed
                 else (lobpcg_mod, "lobpcg"))
    monkeypatch.setattr(mod, name, recording)
    with pytest.raises(_Stop):
        maxwell_tpu_torch.solve(
            BrickCavity3D(nx=2, ny=2, nz=2), nev=2, tol=1e-8, dtype=dtype,
            refine=refine, distributed=distributed, n_shards=2,
            device="cpu", **given)
    assert seen.get("stall_window") == expect


def _last_json(out):
    lines = [json.loads(l) for l in out.strip().splitlines()
             if l.startswith("{")]
    return lines[-1]


def test_cli_config2_matches_reference_cli(capsys, tmp_path):
    with open(os.path.join(CONFIGS, "config2.json")) as f:
        cfg = json.load(f)
    cfg["problem"].update(nx=8, ny=8)
    path = tmp_path / "config2_8.json"
    path.write_text(json.dumps(cfg))

    assert ref_cli.main([str(path), "--platform", "cpu"]) == 0
    want = _last_json(capsys.readouterr().out)
    assert port_cli.main([str(path), "--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    assert got["converged"] and max(got["residuals"]) <= cfg["solver"]["tol"]
    np.testing.assert_allclose(
        got["eigenvalues"], want["eigenvalues"], rtol=1e-8
    )
    assert got["n"] == want["n"]


def test_cli_unported_solver_raises(tmp_path):
    """A shift-invert needs assembled matrices: on the matrix-free
    operator the CLI raises the reference CLI's ValueError."""
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"problem": {"kind": "rect2d"},
                                "solver": {"kind": "shift_invert"},
                                "storage": {"operator": "stencil"}}))
    with pytest.raises(ValueError, match="assembled matrices"):
        port_cli.main([str(path), "--device", "cpu"])
