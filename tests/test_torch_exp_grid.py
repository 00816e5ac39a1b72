"""The BELLPairs per-tile probe of maxwell_tpu_torch (kernels/grid_probes.py,
bench/exp_grid.py) against the JAX package's probe on the CPU, where the
wrappers run their plain versions.

The reference's six probe kernels (maxwell_tpu/bench/exp_grid.py) are
closures inside main() with no interpret switch (and main() writes
exp_grid_results.json where it runs), so each plain version is held to its
kernel body restated in jnp, per grid step, on the reference's own draws at
a small T. The CUDA kernels themselves are tested in test_torch_cuda.py."""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu_torch.bench import exp_grid
from maxwell_tpu_torch.kernels import grid_probes as gp

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
T = 10  # > 8 and not a multiple of 8
R, B, CP, NCH, LIVE = 16, 8, 8, 6, 3
HI = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module")
def data():
    return exp_grid.make_inputs(T)


def _slice(X, c):
    return X[int(c) * B: int(c) * B + 2 * B]


def _cat_panels(cols, X, i, q0, q1):
    """exp_grid.py:143-150 for the (R, NCH * Cp) SMEM block of tile i."""
    blk = cols[R * i: R * (i + 1)]
    return jnp.stack([jnp.concatenate([_slice(X, blk[r, q])
                                       for q in range(q0, q1)], axis=0)
                      for r in range(R)])


def _reference(name, d):
    """The variant's kernel body (exp_grid.py:69-199) per grid step i,
    restated in jnp, the tiles' outputs stacked."""
    X, cols, nch = jnp.asarray(d["X"]), d["cols"], d["nch"]
    vals = jnp.asarray(d["vals"])
    out = []
    for i in range(T):
        if name in ("e0_grid1", "e1_grid6"):
            o = X[0:R * B]  # e1: written at j == 0, the other steps empty
        elif name == "e2_grid6_when":
            for j in range(NCH):
                if j == 0:
                    o = X[0:R * B]
                if j < nch[i]:
                    o = o + X[0:R * B]
        elif name == "e3_acc424":
            acc = jnp.zeros((2 * B, 8), jnp.float32)
            blk = cols[R * i: R * (i + 1)]
            for r in range(R):
                for q in range(LIVE * CP):
                    acc = acc + _slice(X, blk[r, q])
            o = jnp.tile(acc, (R // 2, 1))
        elif name == "e4_cat424":
            acc = jnp.zeros((R, 2 * B, 8), jnp.float32)
            for c in range(LIVE):
                xg = _cat_panels(cols, X, i, c * CP, (c + 1) * CP)
                acc = acc + xg.reshape(R, CP, 2 * B, 8).sum(axis=1)
            o = acc.reshape(R * 2 * B, 8)[0:R * B]
        else:
            acc = jnp.zeros((R, B, 8), jnp.float32)
            vb = vals[R * B * i: R * B * (i + 1)]
            for c in range(LIVE):
                xg = _cat_panels(cols, X, i, c * CP, (c + 1) * CP)
                acc = acc + jnp.einsum(
                    "rik,rkm->rim",
                    vb[:, c * CP * 2 * B:(c + 1) * CP * 2 * B].reshape(
                        R, B, CP * 2 * B),
                    xg, preferred_element_type=jnp.float32, precision=HI)
            o = acc.reshape(R * B, 8)
        out.append(o)
    return np.asarray(jnp.concatenate(out))


def _args(name, t):
    return {"e0_grid1": (t["X"], T), "e1_grid6": (t["X"], T),
            "e2_grid6_when": (t["nch"], t["X"]),
            "e3_acc424": (t["cols"], t["X"], LIVE),
            "e4_cat424": (t["cols"], t["X"], LIVE),
            "e5_cat424_mm": (t["cols"], t["vals"], t["X"], LIVE)}[name]


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


NAMES = [fn.__name__ for fn in gp.KERNELS]


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_probe_body(data, name):
    """Each wrapper on CPU tensors (its plain version) against the probe
    body in jnp: e0-e2 bit for bit (copies and the same additions in the
    same order), e3-e5 within 1e-6 of max|ref| (f32 sums in another
    order)."""
    gp.reset_counts()
    got = getattr(gp, name)(*_args(name, _torch(data))).numpy()
    want = _reference(name, data)
    assert got.shape == want.shape == (128 * T, 8)
    if name in ("e0_grid1", "e1_grid6", "e2_grid6_when"):
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    c = gp.counts()
    assert c[f"{name}_ref"] == 1 and sum(c.values()) == 1


def test_e2_stops_at_each_tiles_live_count(data):
    """e2 adds X[0:128] once per live step, at most six: live counts 0 to
    8 give 1 to 7 times the block, as the reference's pl.when steps."""
    t = _torch(data)
    nch = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 3], dtype=torch.int32)
    got = gp.e2_grid6_when(nch, t["X"]).view(T, 128, 8)
    want = _reference("e2_grid6_when", {**data, "nch": nch.numpy()})
    np.testing.assert_array_equal(got.reshape(-1, 8).numpy(), want)
    base = t["X"][:128]
    for i, k in enumerate([1, 2, 3, 4, 5, 6, 7, 7, 7, 4]):
        torch.testing.assert_close(got[i], k * base, rtol=1e-6, atol=1e-6)


def test_inputs_are_the_reference_draws():
    """make_inputs draws the reference's arrays in its order
    (exp_grid.py:36-44)."""
    d = exp_grid.make_inputs(T)
    nbr = T * R
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        d["cols"], rng.integers(0, nbr - 1, size=(nbr, NCH * CP),
                                dtype=np.int32))
    np.testing.assert_array_equal(d["nch"], np.full((T,), LIVE, np.int32))
    np.testing.assert_array_equal(d["X"], np.asarray(jnp.asarray(
        rng.standard_normal((nbr * B + B, 8)), jnp.float32)))
    np.testing.assert_array_equal(d["vals"], np.asarray(jnp.asarray(
        rng.standard_normal((nbr * B, NCH * CP * 2 * B)), jnp.float32)))


@pytest.mark.parametrize("name", NAMES)
def test_library_call_matches_plain(data, name):
    """Each variant's library call (the one PyTorch call the probe times
    beside its kernel: e2 a broadcast torch.mul, e3/e4 F.embedding_bag
    sums over X's overlapping 16-row windows) computes the plain version's
    function within its stated bound: 1e-5 of max|plain|, 1e-4 for the
    embedding_bag sums. e2 against e2's own live counts 0 to 8 too."""
    t = _torch(data)
    what, call, as_plain, tol = exp_grid.library(name, t, T)
    want = gp.PLAIN_OF[getattr(gp, name)](*_args(name, t))
    got = as_plain(call())
    assert what and got.shape == want.shape == (128 * T, 8)
    assert (got - want).abs().max() <= tol * want.abs().max()
    if name == "e2_grid6_when":
        t["nch"] = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 3],
                                dtype=torch.int32)
        _, call, as_plain, _ = exp_grid.library(name, t, T)
        want = gp.steps_plain(t["nch"], t["X"])
        assert (as_plain(call()) - want).abs().max() <= (
            1e-5 * want.abs().max())


def _digest(name):
    path = os.path.join(ROOT, name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_probe_on_cpu_writes_only_out(tmp_path, monkeypatch):
    """--device cpu runs the plain versions, times nothing (a CPU has no
    device time), writes its JSON to --out only, and leaves the reference's
    exp_grid_results.json at the root as it was, even when run from the
    root. K11's comparison needs the reference's T 298: at T 10 it is left
    out."""
    before = _digest("exp_grid_results.json")
    monkeypatch.chdir(ROOT)
    out = tmp_path / "g.json"
    assert exp_grid.main(["10", "--device", "cpu", "--out", str(out)]) == 0
    assert _digest("exp_grid_results.json") == before
    r = json.loads(out.read_text())
    assert r["device"] == "cpu" and r["T"] == 10 and r["LIVE"] == LIVE
    for name in NAMES:
        assert r[name]["max_abs_err"] == 0.0 and "ms" not in r[name]
    assert "k11" not in r
    assert r["slice_bytes"] == 10 * R * LIVE * CP * 2 * B * 8 * 4


def test_k11_side_on_cpu():
    """K11 beside e5: its kernel's CPU path against the uncounted plain
    arithmetic on a small RCM brick, untimed on a CPU."""
    r = exp_grid._k11(4, torch.device("cpu"), False, None)
    assert r["grid"] == 4 and r["max_abs_err"] <= 1e-5
    assert r["live_pair_bytes"] == r["live_pairs"] * 2 * B * B * 4
    assert "ms" not in r


def test_probe_defaults_to_the_card(monkeypatch, tmp_path):
    """Without --device the probe runs on the card; with none visible it
    raises (no fall-back to the CPU) and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_grid.main(["--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["f64_x", "wide_x", "short_x", "nch_int64",
                                 "cols_int64", "cols_rows", "live_too_many",
                                 "vals_shape", "non_contiguous"])
def test_wrappers_reject_bad_device_input(bad):
    """A tensor that is not on the CPU takes the kernel path, which checks
    its input before any build or launch (meta tensors stand in for CUDA
    ones); nothing falls back to the plain version."""
    Tm = 3
    X = _meta((128 * Tm + 8, 8))
    cols = _meta((16 * Tm, 48), torch.int32)
    nch = _meta((Tm,), torch.int32)
    vals = _meta((128 * Tm, 768))
    live = LIVE
    if bad == "f64_x":
        X = _meta((128 * Tm + 8, 8), torch.float64)
    elif bad == "wide_x":
        X = _meta((128 * Tm + 8, 9))
    elif bad == "short_x":
        X = _meta((100, 8))
    elif bad == "nch_int64":
        nch = _meta((Tm,), torch.int64)
    elif bad == "cols_int64":
        cols = _meta((16 * Tm, 48), torch.int64)
    elif bad == "cols_rows":
        cols = _meta((16 * Tm + 3, 48), torch.int32)
    elif bad == "live_too_many":
        live = 7
    elif bad == "vals_shape":
        vals = _meta((128 * Tm, 760))
    else:
        X = _meta((8, 128 * Tm + 8)).T
    calls = {"e0_grid1": lambda: gp.e0_grid1(X, Tm),
             "e1_grid6": lambda: gp.e1_grid6(X, Tm),
             "e2_grid6_when": lambda: gp.e2_grid6_when(nch, X),
             "e3_acc424": lambda: gp.e3_acc424(cols, X, live),
             "e4_cat424": lambda: gp.e4_cat424(cols, X, live),
             "e5_cat424_mm": lambda: gp.e5_cat424_mm(cols, vals, X, live)}
    # the operands each case spoils
    hit = {"f64_x": NAMES, "wide_x": NAMES, "short_x": NAMES,
           "non_contiguous": NAMES, "nch_int64": ["e2_grid6_when"],
           "cols_int64": NAMES[3:], "cols_rows": NAMES[3:],
           "live_too_many": NAMES[3:],
           "vals_shape": ["e5_cat424_mm"]}[bad]
    gp.reset_counts()
    for name in hit:
        with pytest.raises(ValueError):
            calls[name]()
    assert not any(gp.counts().values())


@pytest.mark.parametrize("value,ok", [(-1, False), (0, True), (31, True),
                                      (32, False)])
def test_cols_outside_x_are_refused(value, ok):
    """The kernels read X[8 c : 8 c + 16] unchecked, so the wrappers refuse
    a read block column c whose slice leaves X (here X has 2 tiles + 8
    rows: c in [0, 31]); an unread slot may hold anything. A column that
    passed is not read again until the tensor changes in place."""
    cols = torch.zeros((32, 48), dtype=torch.int32)
    X = torch.zeros((2 * 128 + 8, 8))
    cols[5, LIVE * CP - 1] = value
    cols[5, LIVE * CP] = 10**6  # past the live slots: not read
    if ok:
        gp.check_cols(cols, X, LIVE)
        cols[5, LIVE * CP - 1] = 32
    with pytest.raises(ValueError, match="leave"):
        gp.check_cols(cols, X, LIVE)


def test_counts_reset(data):
    t = _torch(data)
    gp.reset_counts()
    gp.e0_grid1(t["X"], T)
    gp.e5_cat424_mm(t["cols"], t["vals"], t["X"], LIVE)
    c = gp.counts()
    assert c["e0_grid1_ref"] == 1 and c["e5_cat424_mm_ref"] == 1
    assert sum(c.values()) == 2
    gp.reset_counts()
    assert not any(gp.counts().values())


@pytest.mark.parametrize("kind", ["cat", "cat_mm"])
@pytest.mark.parametrize("Tn", [10, 37, 298])
def test_row_plan_covers_every_block_row_once(kind, Tn):
    """e4's and e5's row plan on a 132-SM card: every block row walked by
    exactly one warp of one block, the blocks' row counts within 1 of each
    other, and so the warps' of a block; the summary says the same."""
    plan = gp.row_plan(R * Tn, LIVE, 132, kind)
    assert plan.grid == min(132, R * Tn)
    per_block = np.diff(plan.starts())
    assert per_block.sum() == R * Tn and per_block.max() - per_block.min() <= 1
    walked = []
    for b in range(plan.grid):
        counts = [len(plan.rows(b, w)) for w in range(plan.warps)]
        assert max(counts) - min(counts) <= 1 and sum(counts) == per_block[b]
        for w in range(plan.warps):
            walked.extend(plan.rows(b, w).tolist())
    assert sorted(walked) == list(range(R * Tn))
    s = plan.summary()
    assert s["block_rows"]["max"] == per_block.max()
    assert s["warp_rows"]["max"] == max(
        len(plan.rows(b, w)) for b in range(plan.grid)
        for w in range(plan.warps))
    assert s["smem"] == plan.smem <= 232448  # a block's on the H100


@pytest.mark.parametrize("live", [1, 3, 6])
def test_e3_plan_covers_each_live_slot_once(live):
    """e3's gather_sum plan (16-row slices, the first live * 8 of 48 slots
    of each row): its ranges cut the T 16 live * 8 slot list into
    near-equal whole groups, every slot in exactly one range, and the
    slot list maps onto cols' first live * 8 columns of each row."""
    cols = torch.from_numpy(exp_grid.make_inputs(T)["cols"])
    plan = gp.acc_plan(cols, live, 132)
    assert (plan.rows, plan.m, plan.slots, plan.S) == (16, 8, live * CP, 48)
    n = T * R * live * CP
    starts = plan.ranges()
    assert starts[0] == 0 and starts[-1] == n
    assert (np.diff(starts) > 0).all() and not (starts % 4).any()
    assert np.diff(starts).max() - np.diff(starts).min() <= 4
    e = np.arange(n)
    owner = plan.block_of(e)
    assert ((starts[owner] <= e) & (e < starts[owner + 1])).all()
    row, col = e // plan.slots, e % plan.slots
    assert col.max() == live * CP - 1 and row.max() == T * R - 1


@pytest.mark.parametrize("live", [1, 3, 6])
def test_e5_lane_map_emulated(data, live):
    """e5's lane arithmetic (csrc/grid_probes.cu grid_cat_mm_kernel)
    emulated in torch on the probe's draws: lane (k = lane / 2, h = lane %
    2) sums V[i, 16 q + k] X-slice[k, 4 h .. 4 h + 3] over the row's slots,
    then the reduce-scatter over lane bits 1-4 leaves row lane / 4, columns
    4 (lane & 1) + 2 ((lane >> 1) & 1) + {0, 1}: the plain product within
    1e-6 of its max."""
    t = _torch(data)
    cols, X, vals = t["cols"], t["X"], t["vals"]
    nbr, Q = cols.shape
    slots = live * CP
    lane = torch.arange(32)
    kk, h = lane // 2, lane % 2
    V = vals.view(nbr, B, Q, 2 * B)[:, :, :slots]  # (nbr, 8, slots, 16)
    S = gp.slices(cols, X, slots)  # (nbr, slots, 16, 8)
    vk = V[:, :, :, kk]  # (nbr, 8, slots, 32 lanes)
    xk = S[:, :, kk].reshape(nbr, slots, 32, 2, 4)[
        :, :, torch.arange(32), h]  # (nbr, slots, 32, 4)
    acc = torch.einsum("nisl,nslj->nlij", vk, xk).reshape(nbr, 32, 32)
    for step in (16, 8, 4, 2):
        up = (lane & step).bool()[None, :, None]
        lo, hi = acc[:, :, :step], acc[:, :, step:2 * step]
        send, keep = torch.where(up, lo, hi), torch.where(up, hi, lo)
        acc = keep + send[:, lane ^ step]
    Y = torch.zeros(nbr, B, 8)
    j = 4 * (lane & 1) + 2 * ((lane >> 1) & 1)
    Y[:, lane >> 2, j] = acc[:, :, 0]
    Y[:, lane >> 2, j + 1] = acc[:, :, 1]
    want = gp.cat_mm_plain(cols, vals, X, live).view(nbr, B, 8)
    assert (Y - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("bad", [dict(live=9), dict(live=0), dict(nbr=0),
                                 dict(sms=0), dict(kind="acc")])
def test_row_plan_refuses_what_the_kernels_do_not_take(bad):
    """live past 64 slots (the column registers) or under one chunk, no
    block rows, no SMs (an empty grid), an unknown kind."""
    args = dict(nbr=R * 298, live=LIVE, sms=132, kind="cat_mm")
    args.update(bad)
    with pytest.raises(ValueError):
        gp.row_plan(**args)


def test_profile_grid_needs_the_card(monkeypatch, tmp_path):
    """The plan profile times kernels: without a card it raises and writes
    nothing; on the CPU device too."""
    from maxwell_tpu_torch.bench import profile_grid

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        profile_grid.main(["--out", str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()
    with pytest.raises(RuntimeError, match="needs the card"):
        profile_grid.run(device="cpu")
