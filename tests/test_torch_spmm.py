"""BELLUnion SpMM of maxwell_tpu_torch: the plain PyTorch versions against
the JAX package's Pallas kernels in interpret mode, the wrappers' checks and
the nvcc build's failure mode. The CUDA kernels themselves are tested in
test_torch_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.kernels import spmm as ref_spmm
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.sparse.bellunion import BELLUnion as RefUnion
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.kernels import _build
from maxwell_tpu_torch.kernels import spmm
from maxwell_tpu_torch.sparse.bellunion import BELLUnion

torch.set_num_threads(1)

# f32 summation order differs from the reference's (reference tests :211
# and :408 hold the TPU kernels to scipy at the same bounds)
TOL = {"highest": 1e-5, "b3": 2e-5}


@pytest.fixture(scope="module")
def layouts():
    cav = RefPermuted(RefBrick(nx=6, ny=5, nz=4))
    ref = RefUnion.from_csr(
        cav.K, block=8, dtype=jnp.float32, B=cav.M, to_device=False
    ).bf16x3().to_device()
    port = BELLUnion.from_reference(ref, device="cpu")
    return ref, port


def _x(rows, m, seed):
    return np.random.default_rng(seed).standard_normal((rows, m)).astype(
        np.float32
    )


@pytest.mark.parametrize("precision", ["highest", "b3"])
@pytest.mark.parametrize("stream", ["a", "b"])
@pytest.mark.parametrize("m", [1, 8, 9])
def test_plain_union_matches_pallas_interpret(layouts, m, stream, precision):
    ref, port = layouts
    X = _x(port.n_cols_padded, m, seed=m)
    want = np.asarray(
        ref_spmm.bellunion_matmat_pallas(
            ref, jnp.asarray(X), interpret=True, stream=stream,
            precision=precision,
        )
    )
    got = spmm.bellunion_matmat(
        port, torch.from_numpy(X), stream=stream, precision=precision
    ).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[precision] * np.abs(want).max()


@pytest.mark.parametrize("precision", ["highest", "b3"])
def test_fused_km_equals_single_stream(layouts, precision):
    _, port = layouts
    X = torch.from_numpy(_x(port.n_padded, 9, seed=3))
    Yk, Ym = spmm.bellunion_km_matmat(port, X, precision=precision)
    assert torch.equal(Yk, spmm.bellunion_matmat(port, X, "a", precision))
    assert torch.equal(Ym, spmm.bellunion_matmat(port, X, "b", precision))


@pytest.mark.parametrize("precision", ["highest", "b3"])
def test_matvec_honours_precision(layouts, precision):
    """The reference's matvec drops `precision` (it is not a static
    argument there), so b3 is held against column 0 of its matmat."""
    ref, port = layouts
    x = _x(port.n, 1, seed=5)[:, 0]
    Xw = np.zeros((port.n_cols_padded, 8), np.float32)
    Xw[: port.n, 0] = x
    want = np.asarray(
        ref_spmm.bellunion_matmat_pallas(
            ref, jnp.asarray(Xw), interpret=True, stream="b",
            precision=precision,
        )
    )[:, 0]
    got = spmm.bellunion_matvec(
        port, torch.from_numpy(x), stream="b", precision=precision
    ).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[precision] * np.abs(want).max()


def test_counters_split_kernel_and_plain(layouts):
    _, port = layouts
    spmm.reset_counts()
    X = torch.from_numpy(_x(port.n_padded, 2, seed=1))
    spmm.bellunion_km_matmat(port, X)
    spmm.bellunion_matvec(port, X[:, 0])
    c = spmm.counts()
    assert c["bellunion_km_matmat_ref"] == 1 and c["bellunion_matvec_ref"] == 1
    assert c["bellunion_km_matmat"] == 0 and c["bellunion_matvec"] == 0


@pytest.mark.parametrize(
    "bad", ["f64", "non_contiguous", "missing_split"]
)
def test_wrappers_reject_bad_device_input(layouts, bad):
    """A tensor that is not on the CPU takes the kernel path, which checks
    its input before any build or launch (meta tensors stand in for CUDA
    ones here)."""
    _, port = layouts
    A = port
    precision = "highest"
    if bad == "f64":
        X = torch.empty((port.n_padded, 4), dtype=torch.float64, device="meta")
    elif bad == "non_contiguous":
        X = torch.empty((4, port.n_padded), device="meta").T
    else:
        A = dataclasses.replace(port, vals_h=None, vals_l=None)
        X = torch.empty((port.n_padded, 4), device="meta")
        precision = "b3"
    with pytest.raises(ValueError):
        spmm.bellunion_matmat(A, X, precision=precision)
    with pytest.raises(ValueError):
        spmm.bellunion_km_matmat(A, X, precision=precision)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", str(tmp_path))  # a PATH entry with no nvcc
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
