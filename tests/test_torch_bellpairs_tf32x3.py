"""The arithmetic of the BELLPairs kernels' tensor-core route
(csrc/bellpairs_spmm.cu at m >= 3: 3xTF32 on mma.sync m16n8k8, f32
accumulation), emulated in plain torch, against the JAX package's
`bellpairs_matmat_pallas` (streams a and b) and `bellpairs_km_matmat_pallas`
in interpret mode (f32 einsum at Precision.HIGHEST), on the K/M layout of a
small RCM brick, within the bound the chip smoke holds the kernels to (1e-5
of max|plain|). The emulation follows the kernel: slot by slot up to each
block row's npairs, each (8, 16) panel as two k-steps of 8 (k-step s takes
the panel columns 4t + 2s and 4t + 2s + 1, t < 4), per k-step the three
products lo_x hi_v, hi_x lo_v, hi_x hi_v added in that order, operands
split into TF32 words by round to nearest, ties away, by an integer add
and a mask (as the blocked-ELL kernels' emulation in
test_torch_bsr_tf32x3.py does). The fused
kernel runs each stream's sums exactly as the one-stream kernel does, so
one emulation serves K11, K12, K13 and K14. The kernels themselves are
tested on the card in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.kernels import spmm as ref_spmm
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.sparse.bellpairs import BELLPairs as RefPairs
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.sparse.bellpairs import BELLPairs

torch.set_num_threads(1)

TOL = 1e-5  # chip_smoke.py's TOL["bellpairs"], the reference's bound
WIDTHS = (3, 9, 16, 17, 33)
# the panel columns of each k-step, in the kernel's order
KSTEPS = [[4 * t + 2 * s + e for e in (0, 1) for t in range(4)]
          for s in (0, 1)]
CASES = ("a", "b", "km_k", "km_m")


def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero (cvt.rna.tf32.f32's value), the low 13 bits cleared: the kernel's
    integer add of half an ulp and mask (csrc/tf32x3.cuh tf32_rna)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def bellpairs_tf32x3(A: BELLPairs, X: torch.Tensor, stream: str = "a",
                     passes: int = 3):
    """Y = A X on one value stream as the kernel's tensor-core route adds
    it. passes=1 keeps hi_x hi_v alone (single-pass TF32, which the kernel
    must not be)."""
    b, m = A.b, X.shape[1]
    nbr, Q = A.cols.shape
    vals = A.vals2d if stream == "a" else A.vals2d_b
    V = vals.reshape(nbr, b, Q, 2 * b)
    Y = torch.zeros((nbr, b, m), dtype=torch.float32)
    live = torch.arange(Q)[None, :] < A.npairs.long()[:, None]
    rows16 = torch.arange(2 * b)
    for q in range(Q):
        rows = live[:, q]
        Vq = V[rows, :, q]                                # (r, 8, 16)
        Xg = X[A.cols[rows, q].long()[:, None] * b + rows16]  # (r, 16, m)
        acc = Y[rows]
        for ks in KSTEPS:
            vh, vl = split(Vq[:, :, ks])
            xh, xl = split(Xg[:, ks])
            terms = ((vh, xl), (vl, xh), (vh, xh))[3 - passes:]
            for v, x in terms:
                acc = acc + torch.einsum("rik,rkj->rij", v, x)
        Y[rows] = acc
    return Y.reshape(A.n_padded, m)


def test_ksteps_cover_each_panel_column_once():
    assert sorted(KSTEPS[0] + KSTEPS[1]) == list(range(16))
    # the lane's 16-byte load (4t .. 4t + 3) feeds k-step 0 with its first
    # pair and k-step 1 with its second
    for t in range(4):
        assert KSTEPS[0][t] == 4 * t and KSTEPS[0][t + 4] == 4 * t + 1
        assert KSTEPS[1][t] == 4 * t + 2 and KSTEPS[1][t + 4] == 4 * t + 3


@pytest.fixture(scope="module")
def products():
    """(port layout, X at the widest m, {case: JAX interpret product})."""
    cav = RefPermuted(RefBrick(nx=6, ny=5, nz=4))
    ref = RefPairs.from_csr(cav.K, block=8, Cp=8, dtype=jnp.float32, B=cav.M)
    X = np.random.default_rng(5).standard_normal(
        (ref.n_padded, max(WIDTHS))).astype(np.float32)
    Xj = jnp.asarray(X)
    want = {s: np.asarray(ref_spmm.bellpairs_matmat_pallas(
        ref, Xj, interpret=True, stream=s)) for s in ("a", "b")}
    km = ref_spmm.bellpairs_km_matmat_pallas(ref, Xj, interpret=True)
    want.update(km_k=np.asarray(km[0]), km_m=np.asarray(km[1]))
    return BELLPairs.from_reference(ref, device="cpu"), X, want


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_tf32x3_matches_pallas_interpret(products, case, m):
    A, X, want = products
    stream = "a" if case in ("a", "km_k") else "b"
    got = bellpairs_tf32x3(A, torch.from_numpy(X[:, :m].copy()),
                           stream).numpy()
    w = want[case][:, :m]
    assert got.shape == w.shape
    err = np.abs(got - w).max()
    assert err <= TOL * np.abs(w).max(), (case, m, err)


def test_single_pass_tf32_misses_the_bound(products):
    """The reason the kernel takes three passes: one pass of TF32 on the
    same inputs is off by far more than 1e-5 of max|plain|."""
    A, X, want = products
    got = bellpairs_tf32x3(A, torch.from_numpy(X[:, :9].copy()),
                           passes=1).numpy()
    w = want["a"][:, :9]
    assert np.abs(got - w).max() > 10 * TOL * np.abs(w).max()
