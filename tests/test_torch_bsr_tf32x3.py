"""The arithmetic of the blocked-ELL kernel's tensor-core route
(csrc/bsr_spmm.cu at m >= 3: 3xTF32 on mma.sync m16n8k8, f32 accumulation),
emulated in plain torch, against the JAX package's `bsr_matmat_pallas` in
interpret mode (f32 einsum at Precision.HIGHEST), on K and M of a small RCM
brick and config 1's M, within the bound the chip smoke holds the kernel to
(1e-5 of max|plain|). The emulation rounds to TF32 as the kernel does, by
an integer add and a bit mask (round to nearest, ties away from zero: the
value cvt.rna gives), splits each operand into hi and lo,
and adds each slot's three products in the kernel's order (lo_x hi_v, hi_x
lo_v, hi_x hi_v). The kernel itself is tested on the card in
test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.kernels import spmm as ref_spmm
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.sparse.bsr import BSRMatrix as RefBSR
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.sparse.bsr import BSRMatrix

torch.set_num_threads(1)

TOL = 1e-5  # chip_smoke.py's TOL["bsr"], the reference's SpMM test bound
WIDTHS = (3, 9, 16, 17, 33)
# the JAX product is taken once per operator at the widest m; a column of
# A X depends on that column of X alone, so each width is its first columns
CASES = ("brick4_K", "brick4_M", "config1_M")


def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero (cvt.rna.tf32.f32's value), the low 13 bits cleared: the kernel's
    integer add of half an ulp and mask."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def bsr_tf32x3(A: BSRMatrix, X: torch.Tensor, passes: int = 3):
    """Y = A X as the kernel's tensor-core route adds it: slot by slot up to
    each row's slot_count, per slot the products lo_x hi_v, hi_x lo_v and
    hi_x hi_v, each summed over the slot's 8 k and added to the f32
    accumulator in that order. passes=1 keeps hi_x hi_v alone (single-pass
    TF32, which the kernel must not be)."""
    b, m = A.b, X.shape[1]
    Xb = X.reshape(-1, b, m)
    Y = torch.zeros((A.n_brows, b, m), dtype=torch.float32)
    live = torch.arange(A.slots)[None, :] < A.slot_count.long()[:, None]
    for s in range(A.slots):
        rows = live[:, s]
        V = A.blocks[rows, s]                      # (r, 8, 8)
        Xg = Xb[A.cols[rows, s].long()]            # (r, 8, m)
        vh, vl = split(V)
        xh, xl = split(Xg)
        terms = ((vh, xl), (vl, xh), (vh, xh))[3 - passes:]
        acc = Y[rows]
        for v, x in terms:
            acc = acc + torch.einsum("riq,rqj->rij", v, x)
        Y[rows] = acc
    return Y.reshape(A.n_padded, m)


@pytest.fixture(scope="module")
def products():
    """{case: (port layout, X at the widest m, JAX interpret product)}."""
    brick = RefPermuted(RefBrick(nx=4, ny=4, nz=4))
    mats = {"brick4_K": brick.K, "brick4_M": brick.M,
            "config1_M": RefRect(nx=16, ny=16).M}
    out = {}
    for i, (case, mat) in enumerate(mats.items()):
        ref = RefBSR.from_csr(mat, block=8, dtype=jnp.float32)
        X = np.random.default_rng(i).standard_normal(
            (ref.n_padded, max(WIDTHS))).astype(np.float32)
        want = np.asarray(ref_spmm.bsr_matmat_pallas(ref, jnp.asarray(X),
                                                     interpret=True))
        out[case] = (BSRMatrix.from_reference(ref, device="cpu"), X, want)
    return out


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    a = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 3.0e-3], dtype=torch.float32)
    got = tf32(a)
    assert got[0].item() == one + ulp and got[1].item() == -(one + ulp)
    assert got[2].item() == one and got[3].item() == one + 2 * ulp
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = split(a)  # 22 of a's 24 significant bits survive
    assert ((hi + lo - a).abs() <= 2.0**-21 * a.abs()).all()


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_tf32x3_matches_pallas_interpret(products, case, m):
    A, X, want = products[case]
    got = bsr_tf32x3(A, torch.from_numpy(X[:, :m].copy())).numpy()
    want = want[:, :m]
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (case, m, err)


def test_single_pass_tf32_misses_the_bound(products):
    """The reason the kernel takes three passes: one pass of TF32 on the
    same inputs is off by far more than 1e-5 of max|plain|."""
    A, X, want = products["brick4_K"]
    got = bsr_tf32x3(A, torch.from_numpy(X[:, :9].copy()), passes=1).numpy()
    err = np.abs(got - want[:, :9]).max()
    assert err > 10 * TOL * np.abs(want[:, :9]).max()
