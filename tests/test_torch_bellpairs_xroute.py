"""bench/bellpairs_xroute.py, the measurement that chose the BELLPairs
body's X route: its route-(b) patch still applies to csrc/bellpairs_spmm.cu
(each anchor found once), and the script refuses to run without a card.
The timing itself runs on the card."""

import pytest
import torch

from maxwell_tpu_torch.bench import bellpairs_xroute as xr
from maxwell_tpu_torch.kernels import _build


def test_route_b_patch_applies():
    src = (_build.SRC_DIR / "bellpairs_spmm.cu").read_text()
    patched = xr.patched_source(src)
    assert "cp.async.cg.shared.global" in patched
    assert "cp.async" not in src
    # the patch only adds: every line of the kernel is still there
    assert all(line in patched for line in src.splitlines()
               if "ldx<SMEM>(xp + j" not in line and "xr[u] + e * xld" not in line)


def test_patch_refuses_a_missing_anchor():
    with pytest.raises(ValueError):
        xr.patched_source("int main() {}")


def test_run_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError):
        xr.run(grid=4)
