"""The ring shift's copy plan (maxwell_tpu_torch/kernels/halo.py
`ring_shift_plan`, the segments and copy unit that csrc/halo.cu's K6 and
K5's copy blocks use): applied with torch slicing on byte views, it gives
the plain transport `ppermute` bit for bit, over shard counts, halo depths,
odd and even shard lengths, widths, f32 and f64, and both output layouts.
The kernel itself is tested on the card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from maxwell_tpu_torch.kernels import halo

torch.set_num_threads(1)

PAD = 8  # the blocked-ELL buffer's zero rows (the block size)


def _apply(X, D, Hb, own, pad_rows):
    """The plan's copy, segment by segment, into an output whose bytes all
    start as 0xFF (so an unwritten byte shows)."""
    Lb, m = X.shape[0] // D, X.shape[1]
    row_bytes = m * X.element_size()
    unit, segs = halo.ring_shift_plan(D, Lb, Hb, own, pad_rows, row_bytes)
    rows = (Lb if own else 0) + 2 * Hb + pad_rows
    out = torch.full((D * rows * row_bytes,), 255, dtype=torch.uint8)
    xb = X.reshape(-1).view(torch.uint8)
    for dst, src, n in segs:
        out[dst:dst + n] = 0 if src < 0 else xb[src:src + n]
    return unit, segs, out.view(X.dtype).reshape(D * rows, m)


@pytest.mark.parametrize("layout", ["own", "sections"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 3, 9])
@pytest.mark.parametrize("Lb", [5, 6])
@pytest.mark.parametrize("depth", ["0", "1", "Lb"])
@pytest.mark.parametrize("D", [1, 2, 8])
def test_plan_equals_ppermute(D, depth, Lb, m, dtype, layout):
    Hb = {"0": 0, "1": 1, "Lb": Lb}[depth]
    own, pad = (True, PAD) if layout == "own" else (False, 0)
    X = torch.from_numpy(np.random.default_rng(D * 100 + m).standard_normal(
        (D * Lb, m))).to(dtype)
    unit, segs, got = _apply(X, D, Hb, own, pad)
    want = halo.ppermute(X, D, Hb, own, pad)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    # the segments tile the output once, in order, and the unit is the
    # widest that divides every offset and length
    assert [s[0] for s in segs] == sorted(s[0] for s in segs)
    ends = [dst + n for dst, _, n in segs]
    assert [s[0] for s in segs[1:]] == ends[:-1]
    assert sum(n for _, _, n in segs) == got.numel() * got.element_size()
    vals = [v for dst, src, n in segs for v in (dst, max(src, 0), n)]
    assert all(v % unit == 0 for v in vals)
    if unit < 16:
        assert any(v % (2 * unit) for v in vals)
    # five segments per shard at most, none empty
    assert len(segs) <= 5 * D and all(n > 0 for _, _, n in segs)


def test_plan_deep_halo_equals_ppermute():
    """A halo deeper than a shard (which the partitioner sends to the plain
    transport, never to the kernel) still reads one contiguous range per
    half."""
    X = torch.from_numpy(np.random.default_rng(3).standard_normal((8 * 5, 3)))
    for own, pad in ((True, PAD), (False, 0)):
        got = _apply(X, 8, 11, own, pad)[2]
        assert torch.equal(got, halo.ppermute(X, 8, 11, own, pad))


def test_plan_main_shape_moves_16_bytes():
    """At the 8-shard 24^3 main shape (Lb 4,864, Hb 3,640, m 9 f32: 36-byte
    rows, which fail a 16-byte row test) every segment starts and ends on a
    16-byte boundary; 4-byte rows of an odd shard length do not."""
    unit, segs = halo.ring_shift_plan(8, 4864, 3640, True, PAD, 36)
    assert unit == 16
    # per shard own, left, right and the pad's zeros; shard 0's left and
    # shard 7's right halves are zeros
    assert len(segs) == 8 * 4 - 1
    assert halo.ring_shift_plan(8, 5, 1, False, 0, 4)[0] == 4


def test_copy_unit_narrows_to_the_pointers():
    X = torch.zeros(64, dtype=torch.float32)
    assert halo.copy_unit(16, X) == 16
    assert halo.copy_unit(16, X[1:]) == 4
    assert halo.copy_unit(16, X[2:]) == 8
    assert halo.copy_unit(8, X, X[4:]) == 8
