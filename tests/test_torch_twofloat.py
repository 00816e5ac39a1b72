"""maxwell_tpu_torch.utils.twofloat against maxwell_tpu.utils.twofloat and
against numpy f64 oracles. Inputs are made with numpy from a seed; both
packages run on the CPU. Each double-word result is held to the oracle at
<= 8u^2 (u = 2^-24) relative to its largest magnitude, and to the
reference's result at the same bound; the error-free transforms are held to
exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.utils import twofloat as ref_tf
from maxwell_tpu_torch.utils import twofloat as tf

torch.set_num_threads(1)

U2 = 2.0**-48
TOL = 8 * U2


def _rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape) * scale


def _pair(x64):
    h, l = tf.dw_from_f64(x64)
    return h, l, tf.dw_to_f64(h, l)  # the exactly representable dw value


def _port(fn, *arrays):
    out = fn(*(torch.from_numpy(np.asarray(a)) for a in arrays))
    return tuple(o.numpy().astype(np.float64) for o in out)


def _ref(fn, *arrays):
    out = fn(*(jnp.asarray(a, jnp.float32) for a in arrays))
    return tuple(np.asarray(o, np.float64) for o in out)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("op", ["two_sum", "fast_two_sum", "two_prod"])
def test_error_free_transforms_exact(op):
    a = _rand(2000, 1).astype(np.float32)
    b = (_rand(2000, 2) * (1e-4 if op == "fast_two_sum" else 1.0)).astype(
        np.float32
    )
    s, e = _port(getattr(tf, op), a, b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    want = a64 * b64 if op == "two_prod" else a64 + b64
    np.testing.assert_array_equal(s + e, want)
    rs, re = _ref(getattr(ref_tf, op), a, b)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(e, re)


@pytest.mark.parametrize("op", ["dw_add", "dw_mul"])
def test_dw_binary_ops(op):
    xh, xl, x64 = _pair(_rand(4096, 5))
    yh, yl, y64 = _pair(_rand(4096, 6) + 3.0)  # no cancellation in add
    want = x64 + y64 if op == "dw_add" else x64 * y64
    got = tf.dw_to_f64(*_port(getattr(tf, op), xh, xl, yh, yl))
    assert _rel(got, want) <= TOL
    ref = ref_tf.dw_to_f64(*_ref(getattr(ref_tf, op), xh, xl, yh, yl))
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("op", ["dw_mul_f", "dw_div_f"])
def test_dw_scalar_ops(op):
    xh, xl, x64 = _pair(_rand(1024, 7))
    c = (_rand(1024, 8) + 3.0).astype(np.float32)
    c64 = c.astype(np.float64)
    want = x64 * c64 if op == "dw_mul_f" else x64 / c64
    got = tf.dw_to_f64(*_port(getattr(tf, op), xh, xl, c))
    assert _rel(got, want) <= TOL
    ref = ref_tf.dw_to_f64(*_ref(getattr(ref_tf, op), xh, xl, c))
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("n", [1, 7, 1024, 20_000])
def test_dw_sum(n):
    xh, xl, x64 = _pair(_rand((n, 3), 9) + 0.5)
    got = tf.dw_to_f64(*_port(lambda h, l: tf.dw_sum(h, l, dim=0), xh, xl))
    want = x64.sum(axis=0)
    assert _rel(got, want) <= TOL
    ref = ref_tf.dw_to_f64(
        *_ref(lambda h, l: ref_tf.dw_sum(h, l, axis=0), xh, xl)
    )
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("op", ["dw_dot_cols", "dw_gram"])
@pytest.mark.parametrize("m", [1, 3])
def test_dw_block_reductions(op, m):
    xh, xl, x64 = _pair(_rand((3000, m), 10) + 0.25)
    yh, yl, y64 = _pair(_rand((3000, m), 11) + 0.25)
    want = (x64 * y64).sum(axis=0) if op == "dw_dot_cols" else x64.T @ y64
    got = tf.dw_to_f64(*_port(getattr(tf, op), xh, xl, yh, yl))
    assert _rel(got, want) <= TOL
    ref = ref_tf.dw_to_f64(*_ref(getattr(ref_tf, op), xh, xl, yh, yl))
    assert _rel(got, ref) <= TOL


def test_dw_matmul_small():
    xh, xl, x64 = _pair(_rand((2000, 4), 12))
    ch, cl, c64 = _pair(_rand((4, 3), 13) + 2.0)
    got = tf.dw_to_f64(*_port(tf.dw_matmul_small, xh, xl, ch, cl))
    want = x64 @ c64
    err = np.abs(got - want) / (np.abs(x64) @ np.abs(c64))
    assert err.max() <= TOL
    ref = ref_tf.dw_to_f64(*_ref(ref_tf.dw_matmul_small, xh, xl, ch, cl))
    assert (np.abs(got - ref) / (np.abs(x64) @ np.abs(c64))).max() <= TOL


def test_dw_from_to_f64_match_reference():
    x = _rand(100, 14) * 1e3
    h, l = tf.dw_from_f64(x)
    rh, rl = ref_tf.dw_from_f64(x)
    np.testing.assert_array_equal(h, rh)
    np.testing.assert_array_equal(l, rl)
    np.testing.assert_array_equal(
        tf.dw_to_f64(torch.from_numpy(h), torch.from_numpy(l)),
        ref_tf.dw_to_f64(rh, rl),
    )
    assert np.abs(tf.dw_to_f64(h, l) - x).max() <= U2 * np.abs(x).max()


def test_dw_renorm_matches_reference():
    """fast_two_sum of a pair whose low word is not yet within half an ulp
    of its high word: the same words as the reference's."""
    h = _rand(2000, 11).astype(np.float32)
    l = (_rand(2000, 12) * 1e-3).astype(np.float32)
    got = _port(tf.dw_renorm, h, l)
    want = _ref(ref_tf.dw_renorm, h, l)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.all(np.abs(got[1]) <= np.spacing(np.abs(got[0]).astype(
        np.float32)).astype(np.float64) / 2)


def test_dw_neg_matches_reference():
    h, l, _ = _pair(_rand(1000, 13))
    got = _port(tf.dw_neg, h, l)
    want = _ref(ref_tf.dw_neg, h, l)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], -h.astype(np.float64))


@pytest.mark.parametrize("s", [0.25, 2.0, 1024.0, 2.0**-20])
def test_dw_scale_pow2_matches_reference(s):
    h, l, x = _pair(_rand(1000, 14))
    sc = np.float32(s)
    got = tf.dw_scale_pow2(torch.from_numpy(h), torch.from_numpy(l),
                           torch.tensor(sc))
    want = ref_tf.dw_scale_pow2(jnp.asarray(h), jnp.asarray(l), sc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # error-free: the pair's value times s exactly
    np.testing.assert_array_equal(tf.dw_to_f64(*got), x * s)
