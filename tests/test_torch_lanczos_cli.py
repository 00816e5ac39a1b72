"""The port's CLI with the Krylov solver kinds on config 1 (2D, 16x16):
"lanczos" as written (f64) against the reference CLI, "tr_lanczos", and the
f32 blocked-ELL route (`storage.kernel: "pallas"`, refined to 1e-8) through
the kernels' plain versions on the CPU."""

import json
import os

import numpy as np
import pytest
import scipy.linalg
import torch

from maxwell_tpu.cli import run as ref_cli
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.kernels import bsr_spmm
from maxwell_tpu_torch.problems import RectCavity2D

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.fixture(scope="module")
def config1():
    with open(os.path.join(CONFIGS, "config1.json")) as f:
        cfg = json.load(f)
    p = cfg["problem"]
    cav = RectCavity2D(a=p["a"], b=p["b"], nx=p["nx"], ny=p["ny"])
    dense = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(),
                              eigvals_only=True)
    return cfg, np.sort(dense[dense > 1e-8])[: cfg["solver"]["nev"]]


def _last_json(out):
    return [json.loads(l) for l in out.strip().splitlines()
            if l.startswith("{")][-1]


def _run_port(cfg, tmp_path, capsys, name):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    bsr_spmm.reset_counts()
    assert port_cli.main([str(path), "--device", "cpu"]) == 0
    return _last_json(capsys.readouterr().out), bsr_spmm.counts()


def test_cli_config1_matches_reference_cli(config1, capsys):
    cfg, discrete = config1
    path = os.path.join(CONFIGS, "config1.json")
    assert ref_cli.main([path, "--platform", "cpu"]) == 0
    want = _last_json(capsys.readouterr().out)
    assert port_cli.main([path, "--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    assert got["converged"] and max(got["residuals"]) <= 1e-8
    assert got["n"] == want["n"]
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=1e-8)
    np.testing.assert_allclose(got["eigenvalues"], discrete, rtol=1e-8)
    assert max(got["analytic_rel_err"]) <= 2.5e-2


@pytest.mark.parametrize("kind", ["lanczos", "tr_lanczos"])
def test_cli_pallas_f32_refined(config1, tmp_path, capsys, kind):
    """config 1's f32 blocked-ELL route: the device solve at f32 through the
    kernels' plain versions here, then the host f64 refine to 1e-8."""
    cfg, discrete = config1
    cfg = json.loads(json.dumps(cfg))
    cfg["storage"] = {"dtype": "f32", "kernel": "pallas"}
    cfg["solver"].update(kind=kind, refine=True)
    if kind == "tr_lanczos":
        cfg["solver"].update(ncv=24, max_restarts=60)
    rep, counts = _run_port(cfg, tmp_path, capsys, kind)
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert "t_refine_s" in rep
    np.testing.assert_allclose(rep["eigenvalues"], discrete, rtol=1e-8)
    assert counts["bsr_matvec_ref"] > 0
    assert counts["bsr_matvec"] == counts["bsr_matmat"] == 0


def test_cli_tr_lanczos_f64(config1, tmp_path, capsys):
    cfg, discrete = config1
    cfg = json.loads(json.dumps(cfg))
    cfg["solver"].update(kind="tr_lanczos", ncv=24, max_restarts=60,
                         tol=1e-9)
    rep, counts = _run_port(cfg, tmp_path, capsys, "trl64")
    assert rep["converged"] and rep["iterations"] > 24
    np.testing.assert_allclose(rep["eigenvalues"], discrete, rtol=1e-8)
    assert all(v == 0 for v in counts.values())  # "ref": no kernel wrapper


@pytest.mark.parametrize("kind", ["shift_invert", "lobpcg_dist"])
def test_cli_unported_kinds_raise(tmp_path, kind):
    """On the matrix-free operator: shift_invert raises the reference CLI's
    ValueError (it factors assembled matrices) for a brick3d as for a
    rect2d; lobpcg_dist on the distributed stencil operator takes brick3d
    problems only and raises the reference CLI's ValueError ("3D-only")
    for a rect2d."""
    pkind = "brick3d" if kind == "shift_invert" else "rect2d"
    cfg = {"problem": {"kind": pkind}, "solver": {"kind": kind},
           "storage": {"operator": "stencil"}}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    match = "assembled matrices" if kind == "shift_invert" else "3D-only"
    with pytest.raises(ValueError, match=match):
        port_cli.main([str(path), "--device", "cpu"])
