"""Double-word f32 ("two-float") arithmetic: a value is carried as the
unevaluated sum hi + lo of two f32 with |lo| <= ulp(hi)/2, about 48 bits of
significand (unit roundoff ~2^-48 ~ 4e-15). A copy of
maxwell_tpu/utils/twofloat.py as plain tensor functions.

The algorithms are the error-free transformations of Dekker and Knuth and
the double-word operations of Joldes, Muller & Popescu (ACM TOMS 2017):
two_sum, the Dekker split and two_prod, and double-word add/mul with
relative error O(u^2), u = 2^-24.

Exactness rests on every operation being rounded on its own. Eager PyTorch
runs each operation below as its own kernel, so nothing contracts a * b - p
into an FMA. Keep it that way: never wrap these functions in torch.compile
and never fuse them into one CUDA kernel built with FMA contraction on.

Arguments are tensors of one f32 dtype; a 0-d tensor broadcasts. Pass a
scalar factor as a 0-d tensor: a Python float would be split in f64
arithmetic and break `two_prod`.
"""

from __future__ import annotations

import numpy as np
import torch

# Dekker split factor for f32: 2^12 + 1 (splits the 24-bit significand into
# two 12-bit halves, each exactly representable)
_SPLIT = 4097.0


def two_sum(a, b):
    """Exact a + b = s + e with s = fl(a+b) (Knuth, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Exact a + b = s + e assuming |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Exact a * b = p + e with p = fl(a*b) (Dekker, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# double-word ops: (xh, xl) with |xl| <= ulp(xh)/2
# ---------------------------------------------------------------------------


def dw_renorm(h, l):
    """Re-establish |l| <= ulp(h)/2 (fast_two_sum; |h| >= |l| holds for
    every producer below)."""
    return fast_two_sum(h, l)


def dw_add(xh, xl, yh, yl):
    """(x + y) to relative error ~3u^2 (AccurateDWPlusDW, sans branches)."""
    sh, sl = two_sum(xh, yh)
    th, tl = two_sum(xl, yl)
    c = sl + th
    vh, vl = fast_two_sum(sh, c)
    w = tl + vl
    return fast_two_sum(vh, w)


def dw_neg(xh, xl):
    return -xh, -xl


def dw_scale_pow2(xh, xl, s):
    """Multiply by an exact power of two (error-free)."""
    return xh * s, xl * s


def dw_mul_f(xh, xl, c):
    """(x * c) for single-f32 c, relative error ~2u^2."""
    ph, pl = two_prod(xh, c)
    return fast_two_sum(ph, pl + xl * c)


def dw_mul(xh, xl, yh, yl):
    """(x * y), relative error ~5u^2 (DWTimesDW, product of lows dropped)."""
    ph, pl = two_prod(xh, yh)
    t = xh * yl + xl * yh
    return fast_two_sum(ph, pl + t)


def dw_div_f(xh, xl, c):
    """(x / c) for single-f32 c via one Newton-refined quotient."""
    q1 = xh / c
    ph, pl = two_prod(q1, c)
    # remainder r = x - q1*c computed in dw (exact products)
    rh, rl = dw_add(xh, xl, -ph, -pl)
    q2 = (rh + rl) / c
    return fast_two_sum(q1, q2)


def dw_from_f64(x):
    """Split host f64 into an (hi, lo) f32 numpy pair with hi + lo == x to
    ~2^-48 relative."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def dw_to_f64(h, l):
    """Host reconstruction of a pair (tensors on any device, or arrays)."""
    if isinstance(h, torch.Tensor):
        h, l = h.cpu().numpy(), l.cpu().numpy()
    return np.asarray(h, np.float64) + np.asarray(l, np.float64)


def dw_sum(h, l, dim=0):
    """Accurate reduction along `dim` by pairwise dw_add (error ~log2(n) *
    u^2 per element). Pads to the next power of two with zeros."""
    h = torch.movedim(h, dim, 0)
    l = torch.movedim(l, dim, 0)
    n = h.shape[0]
    p = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if p != n:
        pad = h.new_zeros((p - n,) + tuple(h.shape[1:]))
        h = torch.cat([h, pad])
        l = torch.cat([l, pad])
    while h.shape[0] > 1:
        k = h.shape[0] // 2
        h, l = dw_add(h[:k], l[:k], h[k:], l[k:])
    return h[0], l[0]


def dw_dot_cols(xh, xl, yh, yl):
    """Per-column dot of (n, m) dw blocks: returns the (m,) dw pair."""
    ph, pl = dw_mul(xh, xl, yh, yl)
    return dw_sum(ph, pl, dim=0)


def dw_gram(xh, xl, yh, yl):
    """X^T Y for (n, m) dw blocks -> (m, m) dw pair, one vectorized dw pass
    per column of Y."""
    m = yh.shape[1]
    xh_t, xl_t = xh.T, xl.T  # (m, n)
    cols_h, cols_l = [], []
    for j in range(m):
        ph, pl = dw_mul(xh_t, xl_t, yh[:, j][None, :], yl[:, j][None, :])
        gh, gl = dw_sum(ph, pl, dim=1)
        cols_h.append(gh)
        cols_l.append(gl)
    return torch.stack(cols_h, dim=1), torch.stack(cols_l, dim=1)


def dw_matmul_small(xh, xl, ch, cl):
    """(n, m) dw block @ (m, k) dw matrix -> (n, k) dw, unrolled over both
    small axes with dw accumulation (a basis rotation X <- X C that keeps
    the low words); each term is a 0-d tensor times a column."""
    m, k = ch.shape
    cols_h, cols_l = [], []
    for jj in range(k):
        oh = xh.new_zeros((xh.shape[0],))
        ol = torch.zeros_like(oh)
        for j in range(m):
            th, tl = dw_mul(xh[:, j], xl[:, j], ch[j, jj], cl[j, jj])
            oh, ol = dw_add(oh, ol, th, tl)
        cols_h.append(oh)
        cols_l.append(ol)
    return torch.stack(cols_h, dim=1), torch.stack(cols_l, dim=1)
