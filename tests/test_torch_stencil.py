"""maxwell_tpu_torch's matrix-free pencils (StencilPencil3D, StencilPencil2D)
and the plain version of the tap-stencil kernel against maxwell_tpu's, on
the same numpy inputs, on the CPU.

Tolerances, relative to max |reference|: f32 applies 1e-6 (f32 summation
in another order; the reference's own XLA and Pallas-interpret tap paths
agree to ~1e-7 at (6, 5, 4)), f64 applies 1e-12, the double-word apply
(hi + lo in f64) 1e-13.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.problems.stencil2d import StencilPencil2D as RefStencil2D
from maxwell_tpu.problems.stencil3d import StencilPencil3D as RefStencil3D
from maxwell_tpu_torch.kernels import stencil_taps as kst
from maxwell_tpu_torch.problems.stencil2d import StencilPencil2D
from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-6),
          "f64": (jnp.float64, torch.float64, 1e-12)}
GRIDS = [(6, 5, 4), (8, 8, 8)]
MODES = {"K": (True, False), "M": (False, True), "KM": (True, True)}


def _half_fill(n):
    eps = np.ones((n, n, n))
    eps[: n // 2] = 2.5
    return eps


def _pencils(dims, dt, **kw):
    jdt, tdt, tol = DTYPES[dt]
    nx, ny, nz = dims
    ref = RefStencil3D.build(a=1.0, b=0.8, c=1.3, nx=nx, ny=ny, nz=nz,
                             dtype=jdt, **kw)
    port = StencilPencil3D.build(a=1.0, b=0.8, c=1.3, nx=nx, ny=ny, nz=nz,
                                 dtype=tdt, device="cpu", **kw)
    return ref, port, tol


def _block(pencil, m, seed, dtype):
    # random on every row, masked ones included: the applies mask
    # themselves
    X = np.random.default_rng(seed).standard_normal((pencil.n_padded, m))
    return X.astype(np.dtype(dtype))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("dims", GRIDS)
def test_tap_tables_match_reference(dims, dt):
    ref, port, _ = _pencils(dims, dt)
    assert port.taps == ref.taps
    assert port.taps_dw == ref.taps_dw
    assert (port.n, port.n_padded) == (ref.n, ref.n_padded)
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))


@pytest.mark.parametrize("fill", ["eps_half", "pmc"])
def test_field_tap_tables_match_reference(fill):
    kw = ({"eps_r": _half_fill(6)} if fill == "eps_half"
          else {"bc": "pmc"})
    ref, port, _ = _pencils((6, 6, 6), "f32", **kw)
    assert port.taps is None and port.ftaps_meta == ref.ftaps_meta
    for got, want in zip(port.ftaps_K + port.ftaps_M,
                         ref.ftaps_K + ref.ftaps_M):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for gp, rp in ((port.ftaps_Kdw, ref.ftaps_Kdw),
                   (port.ftaps_Mdw, ref.ftaps_Mdw)):
        for got, want in zip(gp[0] + gp[1], rp[0] + rp[1]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("dims", GRIDS)
def test_tap_apply_matches_reference_xla(dims, dt, m, mode):
    """The kernel's plain version (what the CPU runs) against the
    reference's XLA tap path."""
    ref, port, tol = _pencils(dims, dt)
    want_K, want_M = MODES[mode]
    X = _block(port, m, m, np.float32 if dt == "f32" else np.float64)
    kst.reset_counts()
    got = port._taps_apply(torch.from_numpy(X), want_K, want_M)
    want = ref._taps_apply(jnp.asarray(X), want_K, want_M)
    assert kst.counts() == {"stencil_taps": 0, "stencil_taps_ref": 1}
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert _rel(g.numpy(), w) <= tol
            assert not g[port.n:].any()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tap_apply_matches_reference_pallas_interpret(mode):
    """The kernel's plain version against `stencil_taps_pallas` itself
    (the reference's Pallas kernel in interpret mode on the CPU)."""
    ref, port, tol = _pencils((6, 5, 4), "f32")
    pallas = dataclasses.replace(ref, taps_impl="pallas")
    want_K, want_M = MODES[mode]
    X = _block(port, 3, 17, np.float32)
    got = kst.stencil_taps_ref(torch.from_numpy(X), port.mask, port.taps,
                               port.shape, want_K, want_M)
    want = pallas._taps_apply(jnp.asarray(X), want_K, want_M)
    for g, w in zip(got, want):
        if g is not None:
            assert _rel(g.numpy(), w) <= tol


@pytest.mark.parametrize("m", [1, 3])
def test_dw_apply_matches_reference(m):
    from maxwell_tpu.utils import twofloat as ref_tf
    from maxwell_tpu_torch.utils import twofloat as tf

    ref, port, _ = _pencils((6, 5, 4), "f32")
    Xh, Xl = tf.dw_from_f64(_block(port, m, 23, np.float64))
    got = port.KM_mm_dw(torch.from_numpy(Xh), torch.from_numpy(Xl))
    want = ref.KM_mm_dw(jnp.asarray(Xh), jnp.asarray(Xl))
    for (gh, gl), (wh, wl) in zip(got, want):
        assert _rel(tf.dw_to_f64(gh, gl),
                    ref_tf.dw_to_f64(np.asarray(wh), np.asarray(wl))) <= 1e-13


def test_dw_field_tap_apply_matches_reference():
    from maxwell_tpu.utils import twofloat as ref_tf
    from maxwell_tpu_torch.utils import twofloat as tf

    ref, port, _ = _pencils((6, 6, 6), "f32", eps_r=_half_fill(6))
    Xh, Xl = tf.dw_from_f64(_block(port, 3, 29, np.float64))
    got = port.KM_mm_dw(torch.from_numpy(Xh), torch.from_numpy(Xl))
    want = ref.KM_mm_dw(jnp.asarray(Xh), jnp.asarray(Xl))
    for (gh, gl), (wh, wl) in zip(got, want):
        assert _rel(tf.dw_to_f64(gh, gl),
                    ref_tf.dw_to_f64(np.asarray(wh), np.asarray(wl))) <= 1e-13


@pytest.mark.parametrize("fill", ["eps_half", "pmc"])
@pytest.mark.parametrize("op", ["K_mm", "M_mm", "KM_mm"])
def test_field_tap_apply_matches_reference(fill, op):
    kw = ({"eps_r": _half_fill(6)} if fill == "eps_half"
          else {"bc": "pmc"})
    ref, port, tol = _pencils((6, 6, 6), "f32", **kw)
    X = _block(port, 3, 31, np.float32)
    got = getattr(port, op)(torch.from_numpy(X))
    want = getattr(ref, op)(jnp.asarray(X))
    if op != "KM_mm":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= tol


@pytest.mark.parametrize("kind", ["vacuum", "eps_half"])
def test_project_matches_reference(kind):
    """Grid-form gradient + FastPoisson3D (vacuum) and the CG projector
    (loaded): masked, gradient-free output."""
    kw = {"eps_r": _half_fill(6)} if kind == "eps_half" else {}
    ref, port, tol = _pencils((6, 6, 6), "f32", **kw)
    X = _block(port, 3, 37, np.float32)
    got = port.project(torch.from_numpy(X))
    want = ref.project(jnp.asarray(X))
    assert _rel(got.numpy(), want) <= tol


def test_element_apply_matches_reference():
    """The panel apply (a pencil without taps), materials included."""
    ref, port, tol = _pencils((5, 4, 3), "f64", eps_r=np.full((5, 4, 3), 2.0))
    ref = dataclasses.replace(ref, ftaps_meta=None)
    port = dataclasses.replace(port, ftaps_meta=None)
    X = _block(port, 2, 41, np.float64)
    for g, w in zip(port.KM_mm(torch.from_numpy(X)),
                    ref.KM_mm(jnp.asarray(X))):
        assert _rel(g.numpy(), w) <= tol


@pytest.mark.parametrize("kw", [{}, {"eps_r": _half_fill(5)}],
                         ids=["vacuum", "eps_half"])
def test_from_reference_applies_identically(kw):
    ref, port, _ = _pencils((5, 5, 5), "f32", **kw)
    got = StencilPencil3D.from_reference(ref, device="cpu")
    X = torch.from_numpy(_block(port, 3, 43, np.float32))
    for g, w in zip(got.KM_mm(X), port.KM_mm(X)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    np.testing.assert_allclose(got.project(X).numpy(),
                               port.project(X).numpy(), rtol=1e-6, atol=1e-6)


def test_kernel_wrapper_counts_plain_calls_on_cpu():
    _, port, _ = _pencils((4, 4, 4), "f32")
    kst.reset_counts()
    X = torch.from_numpy(_block(port, 2, 47, np.float32))
    port.KM_mm(X)
    port.K_mm(X[:, 0])
    assert kst.counts() == {"stencil_taps": 0, "stencil_taps_ref": 2}
    with pytest.raises(ValueError):
        kst.stencil_taps(X, port.mask, port.taps, port.shape, False, False)


@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_wrapper_writes_into_out(mode):
    """`out=` gives the wrapper's results in the caller's tensors, bit for
    bit those it allocates itself; an out that does not fit X raises."""
    want_K, want_M = MODES[mode]
    _, port, _ = _pencils((4, 4, 4), "f32")
    X = torch.from_numpy(_block(port, 3, 53, np.float32))
    args = (X, port.mask, port.taps, port.shape, want_K, want_M)
    out = tuple(torch.full_like(X, np.nan) if w else None
                for w in (want_K, want_M))
    got = kst.stencil_taps(*args, out=out)
    for g, o, w in zip(got, out, kst.stencil_taps(*args)):
        assert (g is None) == (w is None)
        if w is not None:
            assert g is o
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(ValueError):
        kst.stencil_taps(*args, out=(X[:-1], X[:-1]))
    with pytest.raises(ValueError):
        kst.stencil_taps(*args, out=(None, None))


@pytest.mark.parametrize("bc", ["pec", "pmc"])
@pytest.mark.parametrize("op", ["K_mm", "M_mm", "project"])
def test_stencil2d_matches_reference(bc, op):
    ref = RefStencil2D.build(a=1.0, b=0.7, nx=7, ny=5, dtype=jnp.float64,
                             bc=bc)
    port = StencilPencil2D.build(a=1.0, b=0.7, nx=7, ny=5,
                                 dtype=torch.float64, bc=bc, device="cpu")
    assert port.n_padded == ref.n_padded
    X = _block(port, 3, 53, np.float64)
    got = getattr(port, op)(torch.from_numpy(X)).numpy()
    want = np.asarray(getattr(ref, op)(jnp.asarray(X)))
    assert _rel(got, want) <= 1e-12
