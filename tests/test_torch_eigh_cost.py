"""maxwell_tpu_torch/bench/eigh_cost.py on the CPU: its eigh swap reaches
every small eigh site and puts small_eigh back, its "f32" mode is the
eigh before small_eigh (torch.linalg.eigh in the matrix's dtype), and
measure() alternates the modes and summarises each. The timed solves need
the card."""

import numpy as np
import pytest
import torch

import maxwell_tpu_torch
from maxwell_tpu_torch.bench import eigh_cost
from maxwell_tpu_torch.problems import RectCavity2D
from maxwell_tpu_torch.solvers import lobpcg as _lobpcg  # noqa: F401
from maxwell_tpu_torch.solvers import rr

torch.set_num_threads(1)


def _small_solve():
    cav = RectCavity2D(nx=8, ny=8)
    X0 = np.random.default_rng(3).standard_normal((cav.K.shape[0], 7))

    def solve():
        res = maxwell_tpu_torch.solve(cav, dtype=torch.float32, device="cpu",
                                      nev=3, tol=1e-5, refine=False,
                                      maxiter=60, X0=X0)
        return res.iterations, res.timings["device_solve_s"], bool(
            res.converged)

    return solve


def test_eigh_mode_swaps_and_restores():
    import importlib

    lob = importlib.import_module("maxwell_tpu_torch.solvers.lobpcg")
    small = rr.small_eigh
    A = torch.tensor([[2.0, 1.0], [1.0, 3.0]])
    for mode in ("f64", "f32"):
        log = []
        with eigh_cost.eigh_mode(mode, log):
            assert rr.small_eigh is lob.small_eigh is not small
            w, V = rr.small_eigh(A)
        assert rr.small_eigh is small and lob.small_eigh is small
        assert len(log) == 1 and log[0] >= 0
        assert w.dtype == V.dtype == torch.float32
        want = torch.linalg.eigh(A) if mode == "f32" else small(A)
        assert torch.equal(w, want[0]) and torch.equal(V, want[1])
    with pytest.raises(ValueError, match="mode"):
        with eigh_cost.eigh_mode("f16", []):
            pass


def test_measure_alternates_the_modes():
    r = eigh_cost.measure(_small_solve(), 1)
    assert [run["mode"] for run in r["runs"]] == list(eigh_cost.ORDER)
    for mode in ("f64", "f32"):
        s = r["summary"][mode]
        assert s["all_converged"]
        assert s["eigh_calls"]["min"] > 0  # the swap reached the solve
        assert s["solve_s"]["min"] > 0
    # the same mode repeats itself: the CPU solve is deterministic
    f64 = [run for run in r["runs"] if run["mode"] == "f64"]
    assert f64[0]["iterations"] == f64[1]["iterations"]


def test_eigh_cost_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eigh_cost.run()
