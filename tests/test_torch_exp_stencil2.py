"""The tap-stencil shift probe of maxwell_tpu_torch (kernels/stencil_probes.py,
bench/exp_stencil2.py) against the JAX package's probe on the CPU, where
the wrapper runs its plain version.

The reference's seven kernel bodies (maxwell_tpu/bench/exp_stencil2.py::_mk)
run here as pl.pallas_call(..., interpret=True) with the reference's own
grid and BlockSpecs (exp_stencil2.py:116-128), on the reference's field
(default_rng(0)) at small sizes; main() is not called (it reads and writes
exp_stencil2_results.json where it runs). The CUDA kernel itself is tested
in test_torch_cuda.py."""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from maxwell_tpu.bench import exp_stencil2 as ref
from maxwell_tpu_torch.bench import exp_stencil2
from maxwell_tpu_torch.kernels import stencil_probes as sp

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIZES = [(4, 2), (3, 3)]  # (grid, m)


def _pallas(case, grid, m):
    """The reference's kernel for `case` in interpret mode, with its grid
    and BlockSpecs (exp_stencil2.py:115-131), on its field."""
    Y = ZM_rows = grid + 2
    ZM = (grid + 2) * m
    NX = grid + 2

    def spec(off):
        return pl.BlockSpec((1, Y + 2, ZM + 2 * m), lambda i: (i + off, 0, 0),
                            memory_space=pltpu.VMEM)

    f = pl.pallas_call(
        ref._mk(case, Y, ZM, m), grid=(NX,),
        in_specs=[spec(0), spec(1), spec(2)],
        out_specs=pl.BlockSpec((1, ZM_rows, ZM), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NX, Y, ZM), jnp.float32),
        interpret=True,
    )
    Z = jnp.asarray(exp_stencil2.make_field(grid, m))
    return np.asarray(f(Z, Z, Z))


@pytest.fixture(scope="module")
def reference():
    return {(g, m, c): _pallas(c, g, m) for g, m in SIZES for c in sp.CASES}


@pytest.mark.parametrize("grid,m", SIZES)
@pytest.mark.parametrize("case", sp.CASES)
def test_plain_matches_pallas_interpret(reference, grid, m, case):
    """Each case's plain version (the wrapper on a CPU tensor) against the
    reference kernel in interpret mode: 1e-6 of max|ref| (the same f32 taps
    in the same order; the reference may contract a multiply and add)."""
    field = torch.from_numpy(exp_stencil2.make_field(grid, m))
    sp.reset_counts()
    got = sp.shift_probe(case, field, m).numpy()
    want = reference[grid, m, case]
    assert got.shape == want.shape == (grid + 2, grid + 2, (grid + 2) * m)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    c = sp.counts()
    assert c[f"shift_{case}_ref"] == 1 and sum(c.values()) == 1


@pytest.mark.parametrize("grid,m", SIZES)
def test_roll_forms_equal_their_shifted_forms(reference, grid, m):
    """p5 is p1's function and p6 p3's, on both sides: the reference's
    roll kernels give its shifted kernels' values, and so do the port's."""
    field = torch.from_numpy(exp_stencil2.make_field(grid, m))
    for roll, shifted in exp_stencil2.SAME_AS.items():
        a, b = reference[grid, m, roll], reference[grid, m, shifted]
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
        pa = sp.shift_plain(roll, field, m).numpy()
        pb = sp.shift_plain(shifted, field, m).numpy()
        assert np.abs(pa - pb).max() <= 1e-6 * np.abs(pb).max()


def test_field_is_the_reference_draw():
    """make_field is exp_stencil2.py:98-105's field."""
    grid, m = 4, 2
    rng = np.random.default_rng(0)
    want = np.asarray(jnp.asarray(
        rng.standard_normal((grid + 4, grid + 4, (grid + 2) * m + 2 * m)),
        jnp.float32))
    np.testing.assert_array_equal(exp_stencil2.make_field(grid, m), want)


def _digest(name):
    path = os.path.join(ROOT, name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_probe_on_cpu_writes_only_out(tmp_path, monkeypatch):
    """--device cpu runs the plain versions and K4's plain version, times
    nothing, writes its JSON to --out only, and leaves the reference's
    exp_stencil2_results.json at the root as it was, even when run from the
    root."""
    before = _digest("exp_stencil2_results.json")
    monkeypatch.chdir(ROOT)
    out = tmp_path / "s.json"
    assert exp_stencil2.main(["--grid", "4", "--ms", "2", "3", "--device",
                              "cpu", "--out", str(out)]) == 0
    assert _digest("exp_stencil2_results.json") == before
    r = json.loads(out.read_text())
    assert r["device"] == "cpu" and r["grid"] == 4
    for m in (2, 3):
        res = r[f"m{m}"]
        assert (res["NX"], res["Y"], res["ZM"]) == (6, 6, 6 * m)
        assert res["bytes"] == ((8 * 8 * (6 * m + 2 * m)) + 36 * 6 * m) * 4
        assert res["flops"] == 2 * 33 * 36 * 6 * m
        for case in sp.CASES:
            assert res[case]["max_abs_err"] == 0.0 and "ms" not in res[case]
            assert res[case]["library_err"] <= 1e-5 * 600
        assert res["p5"]["err_vs_p1"] <= 1e-5 * 600
        assert res["p6"]["err_vs_p3"] <= 1e-5 * 600
    k4 = r["k4"]
    assert k4["grid"] == 4 and k4["max_abs_err"] == 0.0
    assert k4["outputs"] == k4["n_padded"] * 9 and "ms" not in k4
    # p3 on the field whose outputs are nearest K4's
    p3 = k4["p3_same_outputs"]
    g = p3["grid"]
    assert p3["outputs"] == (g + 2) ** 3 * 9 and p3["max_abs_err"] == 0.0
    assert round(k4["n_padded"] ** (1 / 3)) == g + 2


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("case", sp.CASES)
def test_conv3d_computes_each_case(case, m):
    """The library call timed beside each case: F.conv3d with the case's
    33 taps summed into a 3 x 3 x 3 filter, dilated by m along z, gives the
    plain version's output (1e-6 of max|plain|, f32 sums in another
    order)."""
    field = torch.from_numpy(exp_stencil2.make_field(5, m))
    W = exp_stencil2.conv_weight(case)
    assert float(W.sum()) == sum(c for *_, c in sp._taps(case))
    want = sp.shift_plain(case, field, m)
    got = exp_stencil2.library(field, W, m)
    assert got.shape == want.shape == (7, 7, 7 * m)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6


def test_probe_defaults_to_the_card(monkeypatch, tmp_path):
    """Without --device the probe runs on the card; with none visible it
    raises (no fall-back to the CPU) and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_stencil2.main(["--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["case", "f64", "two_dims", "m_zero",
                                 "m_32", "too_narrow", "non_contiguous"])
def test_wrapper_rejects_bad_device_input(bad):
    """A field that is not on the CPU takes the kernel path, which checks
    its input before any build or launch (meta tensors stand in for CUDA
    ones); nothing falls back to the plain version."""
    case, m = "p3", 8
    field = _meta((8, 8, 64))
    if bad == "case":
        case = "p7"
    elif bad == "f64":
        field = _meta((8, 8, 64), torch.float64)
    elif bad == "two_dims":
        field = _meta((64, 64))
    elif bad == "m_zero":
        m = 0
    elif bad == "m_32":
        m = 32
    elif bad == "too_narrow":
        field = _meta((8, 8, 16))
    else:
        field = _meta((8, 64, 8)).transpose(1, 2)
    sp.reset_counts()
    with pytest.raises(ValueError):
        sp.shift_probe(case, field, m)
    assert not any(sp.counts().values())


def test_unknown_case_raises_on_cpu():
    field = torch.from_numpy(exp_stencil2.make_field(3, 2))
    with pytest.raises(ValueError, match="case"):
        sp.shift_probe("p9", field, 2)


def test_counts_reset():
    field = torch.from_numpy(exp_stencil2.make_field(3, 2))
    sp.reset_counts()
    sp.shift_probe("p0", field, 2)
    sp.shift_probe("p6", field, 2)
    c = sp.counts()
    assert c["shift_p0_ref"] == 1 and c["shift_p6_ref"] == 1
    assert sum(c.values()) == 2
    sp.reset_counts()
    assert not any(sp.counts().values())


# ---------------------------------------------------------------------------
# shift_plan: the windows the kernel stages
# ---------------------------------------------------------------------------

SMS = 132  # the H100 SXM's SMs

@pytest.mark.parametrize("grid", [3, 5, 64, 70])
@pytest.mark.parametrize("m", [1, 8, 9, 17])
def test_shift_plan_windows_cover_every_output_once(grid, m):
    """Every output (i, y, z) of the (grid + 2)^3 m field lies in exactly
    one block's window, for a one-plane case and a three-plane one; no
    cut into x-chunks with two blocks an SM (where NX allows) gives the
    busiest SM fewer staged window-planes, each
    block's shared memory stays within 232,448 bytes and two blocks or
    more fit an SM."""
    n = grid + 2
    for case in ("p1", "p3"):
        plan = sp.shift_plan(n, n, n * m, m, case, SMS)
        hits = np.zeros((n, n, n * m), np.int8)
        for x0, x1, y0, y1, z0, z1 in sp.shift_windows(plan):
            assert x1 > x0 and y1 > y0 and z1 > z0
            hits[x0:x1, y0:y1, z0:z1] += 1
        assert np.all(hits == 1)
        assert 2 * (plan.smem_bytes + 1024) <= 233472  # 2 blocks an SM
        tiles = plan.grid_z * plan.grid_y

        def load(g):  # staged window-planes of the busiest SM
            return -(-tiles * g // SMS) * (-(-n // g) + plan.slots - 2)

        least = min(n, -(-2 * SMS // tiles))
        assert plan.grid_x >= least
        assert all(load(plan.grid_x) <= load(g) for g in range(least, n + 1))
        assert plan.threads % 32 == 0 and plan.tz <= plan.threads <= 256
        assert plan.w >= plan.tz + 2 * m and plan.w % 4 == 0
        assert plan.slots == (4 if case == "p3" else 2)
        assert plan.vec == int((n * m + 2 * m) % 4 == 0)


@pytest.mark.parametrize("sms", [78, 114, 132])
@pytest.mark.parametrize("case", ["p0", "p3"])
def test_shift_plan_follows_the_sm_count(sms, case):
    """The x-chunks come from the card's SM count: at 64^3, m 8 the plan's
    cut gives every SM two blocks at least and its busiest SM the fewest
    staged window-planes of any such cut at that count; the windows do
    not depend on it."""
    n = 66
    plan = sp.shift_plan(n, n, n * 8, 8, case, sms)
    tiles = plan.grid_z * plan.grid_y
    halo = plan.slots - 2

    def load(g):
        return -(-tiles * g // sms) * (-(-n // g) + halo)

    least = min(n, -(-2 * sms // tiles))
    assert plan.grid_x >= least and plan.blocks >= 2 * sms
    assert all(load(plan.grid_x) <= load(g) for g in range(least, n + 1))
    base = sp.shift_plan(n, n, n * 8, 8, case, SMS)
    assert (plan.ty, plan.tz, plan.w, plan.slots) == (base.ty, base.tz,
                                                      base.w, base.slots)


def _windowed(case, field, m, plan):
    """The kernel's arithmetic by the plan: each block's outputs computed
    from its staged halo slice alone (planes x0 .. x1 + 1, rows y0 .. y1 +
    1, lanes z0 .. z1 + 2m - 1 of the field), as shift_plain computes
    them."""
    NX, Y, ZM = plan.NX, plan.Y, plan.ZM
    out = torch.full((NX, Y, ZM), float("nan"))
    for x0, x1, y0, y1, z0, z1 in sp.shift_windows(plan):
        halo = field[x0:x1 + 2, y0:y1 + 2, z0:z1 + 2 * m]
        out[x0:x1, y0:y1, z0:z1] = sp.shift_plain(case, halo, m)
    return out


@pytest.mark.parametrize("grid,m", [(3, 1), (5, 9), (4, 17), (12, 3)])
@pytest.mark.parametrize("case", sp.CASES)
def test_windowed_arithmetic_is_shift_plain(case, grid, m):
    """Each window computed from its staged halo slice alone equals the
    plain version bit for bit: the windows read nothing outside their
    halo."""
    field = torch.from_numpy(exp_stencil2.make_field(grid, m))
    n = grid + 2
    plan = sp.shift_plan(n, n, n * m, m, case, SMS)
    assert plan.blocks > 1
    got = _windowed(case, field, m, plan)
    assert torch.equal(got, sp.shift_plain(case, field, m))


@pytest.mark.parametrize("grid,m", SIZES)
@pytest.mark.parametrize("case", sp.CASES)
def test_windowed_arithmetic_matches_pallas_interpret(reference, grid, m,
                                                      case):
    """The windowed arithmetic against the reference kernel in interpret
    mode: within 1e-5 of max|ref|."""
    field = torch.from_numpy(exp_stencil2.make_field(grid, m))
    n = grid + 2
    plan = sp.shift_plan(n, n, n * m, m, case, SMS)
    got = _windowed(case, field, m, plan)
    want = reference[grid, m, case]
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_shift_plan_stages_the_halo_bytes():
    """staged_bytes counts what the kernel copies, here by hand: a 4 x 4 x
    32 output at m 8 is one 4-row, 32-lane window per plane in 4 chunks of
    one plane; a staged row is 48 lanes (192 bytes, 16-byte copies), a
    plane 6 rows; p6 stages 3 planes per chunk. At m 3 (rows of 18 + 6
    lanes, 33 floats apart) the copies are 4-byte ones: 24 lanes a row."""
    for case, planes in (("p0", 1), ("p6", 3)):
        plan = sp.shift_plan(4, 4, 32, 8, case, SMS)
        assert (plan.vec, plan.ty, plan.tz, plan.grid_x) == (1, 4, 32, 4)
        assert plan.staged_bytes == 4 * planes * 6 * 192
        plan = sp.shift_plan(4, 4, 27, 3, case, SMS)
        assert (plan.vec, plan.tz) == (0, 28)
        assert plan.staged_bytes == 4 * planes * 6 * (27 + 6) * 4


def test_shift_plan_refuses_what_the_kernel_cannot_take():
    for m in (0, 32):
        with pytest.raises(ValueError):
            sp.shift_plan(6, 6, 6 * max(m, 1), m, "p0", SMS)
    with pytest.raises(ValueError, match="case"):
        sp.shift_plan(6, 6, 12, 2, "p7", SMS)
