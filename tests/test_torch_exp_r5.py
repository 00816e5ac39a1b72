"""The port's chain, shift-invert, preconditioner-sweep and double-word
probes (maxwell_tpu_torch/bench/exp_r5chain, exp_r5dist, exp_r5si,
exp_conv, exp_r4chip) on the CPU at tiny sizes, through their command
lines: each returns the keys of its reference probe in maxwell_tpu/bench/
(read from the reference's source), the chains reach 1e-8 with
f64-verified residuals, the double-word transforms are exact, and nothing
is written outside --out: the reference's result files at the repository's
root hash the same before and after."""

import hashlib
import json
import pathlib
import re

import pytest
import torch

from maxwell_tpu_torch.bench import (
    exp_conv,
    exp_r4chip,
    exp_r5chain,
    exp_r5dist,
    exp_r5si,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# probe: (its module, its command line, the reference's key pattern)
PROBES = {
    "exp_r5chain": (exp_r5chain, ["--grid", "6", "--steady", "2"],
                    r'out\["(\w+)"\]'),
    "exp_r5dist": (exp_r5dist, ["--grid", "6", "--slabs", "2", "--steady",
                                "1"], r'out\["(\w+)"\]'),
    "exp_r5si": (exp_r5si, ["--grid2d", "16", "--grid3d", "4"],
                 r'out\["(\w+)"\]'),
    "exp_conv": (exp_conv, ["--grid", "5", "--maxiter", "30"],
                 r'"(\w+)": '),
    "exp_r4chip": (exp_r4chip, ["--union-grid", "5", "--stencil-grid",
                                "6"], r'results\["(\w+)"\]'),
}


def reference_keys(name, pattern):
    src = (ROOT / "maxwell_tpu" / "bench" / f"{name}.py").read_text()
    keys = set(re.findall(pattern, src))
    assert keys
    return keys


def root_results():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(ROOT.glob("exp_*_results.json"))}


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_keys_and_where_it_writes(name, tmp_path, monkeypatch,
                                        capsys):
    mod, argv, pattern = PROBES[name]
    before = root_results()
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out" / f"{name}.json"
    assert mod.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    assert root_results() == before
    assert [p.relative_to(tmp_path) for p in tmp_path.rglob("*")
            if p.is_file()] == [out.relative_to(tmp_path)]
    res = json.loads(out.read_text())
    assert res["device"] == "cpu"
    printed = json.loads(capsys.readouterr().out)
    assert printed == res
    if name == "exp_conv":
        rows = [v for k, v in res.items() if k != "device"]
        assert len(rows) == len(exp_conv.COMBOS)
        for row in rows:
            assert reference_keys(name, pattern) <= set(row)
            assert row["converged"] and row["iters_to_2e6"] >= 0
    else:
        assert reference_keys(name, pattern) <= set(res)
    if name in ("exp_r5chain", "exp_r5dist"):
        assert res["converged"] and res["refine_res"] <= 1e-8
        assert max(res["residuals_f64_verified"]) <= 1e-8
        assert max(res["analytic_rel_err"]) <= 0.05
        assert len(res["solve_steady_s"]) == len(res["refine_dev_steady_s"])
    if name == "exp_r5chain":
        assert res["host_vs_device_eig_rel"] == 0.0
        assert res["refine_host_res"] == res["refine_res"]
    if name == "exp_r5si":
        # the applies are device metrics: not measured on the CPU
        assert res["si_apply_2d128_s"] is None
        assert res["si_apply_64_stencil_s"] is None
        assert len(res["si_solve_2d128_eigs"]) == 4
        assert len(res["si_solve_64_eigs"]) == 3
    if name == "exp_r4chip":
        assert set(res["two_prod_err"]) == {
            "same_shape", "scalar", "row_major_bcast", "col_minor_bcast",
            "outer"}
        assert all(v == 0.0 for v in res["two_prod_err"].values())
        assert res["dw_sum_err"] <= 1e-9
        assert res["union_prod"]["err"] <= 1e-5
        assert res["dw_apply_rel_err"] <= 1e-12
        assert res["dw_apply_64_s"] is None and res["bw_GBps"] is None


def test_r5si_without_solves_skips_them():
    res = exp_r5si.run(16, 4, solves=False, device="cpu")
    assert "si_solve_2d128_s" not in res and "si_solve_64_stencil_s" not in res
    assert res["ldlt_factor_2d128_n"] == 480


def test_r5chain_traces_one_extra_chain(tmp_path):
    res = exp_r5chain.run(5, steady=1, host=False, device="cpu",
                          trace_dir=str(tmp_path))
    assert pathlib.Path(res["trace"]).parent == tmp_path
    assert res["top_kernels"] == []  # no device activity on the CPU
    assert "refine_host_steady_s" not in res
