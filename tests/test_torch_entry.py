"""The port's driver entry points (maxwell_tpu_torch/entry.py) on the CPU:
the flagship step against __graft_entry__.entry()'s on the same start
block, and the distributed dry run's checks.

Bounds: one f32 LOBPCG iteration from the same X0 on the 32x32 rectangle
(the plain blocked-ELL apply in both packages, f32 sums in other orders):
Ritz values within 1e-5 relative and residuals within 1e-5 absolute
(measured: 3e-6 and 5e-7). The dry run's bit-for-bit comparisons are
exactly 0."""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from maxwell_tpu_torch.entry import dryrun_multichip, entry

torch.set_num_threads(1)


def test_entry_step_matches_the_reference():
    fn_ref, (p_ref, X0_ref) = graft.entry()
    theta_ref, res_ref = (np.asarray(v) for v in fn_ref(p_ref, X0_ref))
    fn, (pencil, X0) = entry("cpu")
    assert pencil.kernel == "ref" and X0.device.type == "cpu"
    assert pencil.n_padded == p_ref.n_padded and pencil.n == p_ref.n
    assert X0.shape == X0_ref.shape and X0.dtype == torch.float32
    assert not X0[pencil.n:].any()
    X = torch.from_numpy(np.array(X0_ref, np.float32))
    theta, res = fn(pencil, X)
    np.testing.assert_allclose(theta.numpy(), theta_ref, rtol=1e-5)
    np.testing.assert_allclose(res.numpy(), res_ref, rtol=0, atol=1e-5)
    # the port's own X0 gives a step of the same kind
    theta0, res0 = fn(pencil, X0)
    assert torch.isfinite(theta0).all() and (res0 > 0).all()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_checks(n):
    checks = dryrun_multichip(n, device="cpu")
    assert {"lobpcg_dist_pallas", "lobpcg_dist_slab", "lanczos_dist",
            "lobpcg_dist_union", "spmm_rdma_vs_ppermute", "halo_checksum",
            "spmm_rdma_overlap_vs_union", "lobpcg_dist_dcn",
            "lobpcg_dist_staged", "refine_dw_dist",
            "thick_restart_lanczos_dist", "lobpcg_dist_return_device",
            "refine_dw_dist_return_device", "stage_polish"} <= set(checks)
    for name, v in checks.items():
        if isinstance(v, bool):
            assert v, name
        else:
            assert v == 0.0, (name, v)
