"""The port's CLI with solver kind "lobpcg_dist" (config 4) against the
reference CLI on its 8-device CPU mesh: config 4 as written (f64, 8 shards,
plain torch) with its grid shrunk to 6^3, and the f32 union route refined
on the host to 1e-8 (the reference's TPU route)."""

import json
import os

import numpy as np
import pytest
import torch

from maxwell_tpu.cli import run as ref_cli
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.kernels import halo, spmm

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _last_json(out):
    return [json.loads(l) for l in out.strip().splitlines()
            if l.startswith("{")][-1]


@pytest.fixture(scope="module")
def config4():
    with open(os.path.join(CONFIGS, "config4.json")) as f:
        cfg = json.load(f)
    cfg["problem"].update(nx=6, ny=6, nz=6)
    return cfg


def _write(tmp_path, cfg, name):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_config4_matches_reference_cli(config4, tmp_path, capsys):
    path = _write(tmp_path, config4, "config4_6")
    assert config4["dist"]["n_shards"] == 8
    assert ref_cli.main([path, "--platform", "cpu"]) == 0
    want = _last_json(capsys.readouterr().out)
    assert port_cli.main([path, "--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    assert got["converged"] and max(got["residuals"]) <= 1e-8
    assert got["n"] == want["n"]
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=1e-10)
    assert max(got["analytic_rel_err"]) <= 2.5e-2


def test_cli_config4_union_f32_refined(config4, tmp_path, capsys):
    """f32 "union" shards through the union kernels' plain versions, cut at
    the f32 floor, refined on the host to the config's 1e-8."""
    cfg = json.loads(json.dumps(config4))
    cfg["storage"] = {"dtype": "f32", "kernel": "union"}
    cfg["solver"]["refine"] = True
    spmm.reset_counts()
    halo.reset_counts()
    assert port_cli.main([_write(tmp_path, cfg, "c4u"), "--device",
                          "cpu"]) == 0
    rep = _last_json(capsys.readouterr().out)
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert "t_refine_s" in rep
    np.testing.assert_allclose(rep["eigenvalues"][:3], [20.19417744] * 3,
                               rtol=1e-8)
    assert spmm.counts()["bellunion_matmat_ref"] > 0


def test_cli_config4_staged_batch(config4, tmp_path, capsys):
    """The config's `batch` runs the staged path through the CLI."""
    cfg = json.loads(json.dumps(config4))
    cfg["solver"].update(batch=3, nev=4)
    assert port_cli.main([_write(tmp_path, cfg, "c4b"), "--device",
                          "cpu"]) == 0
    out = capsys.readouterr().out
    rep = _last_json(out)
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert '"stage": 1' in out
    np.testing.assert_allclose(rep["eigenvalues"],
                               [20.194177444728] * 3 + [30.291266167092],
                               rtol=1e-10)


def test_cli_dist_stencil_refused(tmp_path):
    """The distributed stencil operator runs (test_torch_refine_dw_dist.py);
    what it refuses, as the reference does: a 2D problem, and a shard count
    that does not divide nx."""
    path = _write(tmp_path, {"problem": {"kind": "rect2d"},
                             "solver": {"kind": "lobpcg_dist"},
                             "storage": {"operator": "stencil"}}, "c4s")
    with pytest.raises(ValueError, match="3D-only"):
        port_cli.main([path, "--device", "cpu"])
    path = _write(tmp_path, {"problem": {"kind": "brick3d", "nx": 6},
                             "solver": {"kind": "lobpcg_dist"},
                             "storage": {"operator": "stencil"},
                             "dist": {"n_shards": 4}}, "c4s_odd")
    with pytest.raises(ValueError, match="divisible"):
        port_cli.main([path, "--device", "cpu"])
