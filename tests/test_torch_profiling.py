"""maxwell_tpu_torch/utils/profiling.py against maxwell_tpu/utils/
profiling.py: the phase timer's report, spmv_rate, and the trace."""

import json
import time

import pytest
import torch

from maxwell_tpu.utils import profiling as ref
from maxwell_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _phases(timer):
    with timer.phase("setup"):
        pass
    for _ in range(3):
        with timer.phase("solve"):
            time.sleep(0.001)
    with pytest.raises(RuntimeError):
        with timer.phase("fail"):
            raise RuntimeError("counted all the same")
    return json.loads(timer.report())


def test_phase_timer_report_has_the_reference_shape():
    got, want = _phases(profiling.PhaseTimer()), _phases(ref.PhaseTimer())
    assert list(got) == list(want) == ["setup", "solve", "fail"]
    for name in want:
        assert set(got[name]) == set(want[name]) == {"total_s", "calls"}
        assert got[name]["calls"] == want[name]["calls"]
        assert isinstance(got[name]["total_s"], float)
    assert got["solve"]["calls"] == 3 and got["solve"]["total_s"] >= 0.003


@pytest.mark.parametrize("nnz,seconds", [(1000, 0.5), (7, 3e-9), (5, 0.0),
                                         (5, -1.0), (0, 2.0)])
def test_spmv_rate_matches_the_reference(nnz, seconds):
    got, want = profiling.spmv_rate(nnz, seconds), ref.spmv_rate(nnz, seconds)
    assert got == want
    if seconds <= 0:
        assert got == float("inf")


def test_trace_writes_a_chrome_trace_naming_an_op(tmp_path):
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D

    p = StencilPencil3D.build(nx=4, ny=4, nz=4, device="cpu")
    X = torch.randn((p.n_padded, 2), generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path)) as prof:
        p.K_mm(X)
        torch.linalg.qr(torch.ones((8, 3)))
    files = list(tmp_path.iterdir())
    assert files and str(files[0]) == prof.trace_path
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::linalg_qr" in names
    assert profiling.top_kernels(prof) == []  # no device activity here
