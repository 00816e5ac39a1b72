"""The X-gather probe of maxwell_tpu_torch (kernels/gather_probes.py,
bench/exp_gather.py) against the JAX package's probe on the CPU, where the
wrappers run their plain versions.

The reference's seven probe kernels (maxwell_tpu/bench/exp_gather.py) are
closures inside main() with no interpret switch (and main() writes
exp_gather_results.json where it runs), so each plain version is held to
its kernel body restated in jnp, per grid step, on the reference's own
draws at a small T. The CUDA kernels themselves are tested in
test_torch_cuda.py."""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu_torch.bench import exp_gather
from maxwell_tpu_torch.kernels import gather_probes as gpr

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
T, S = 10, 64  # > 8 tiles, not a multiple of 8; the reference's S
R, B, M = 16, 8, 8
P, W = S * B, 4096
NAMES = [fn.__name__ for fn in gpr.KERNELS]


@pytest.fixture(scope="module")
def data():
    return exp_gather.make_inputs(T, S)


def _reference(name, d):
    """The variant's kernel body (exp_gather.py:94-243) per grid step i,
    restated in jnp, the tiles' outputs stacked."""
    X = jnp.asarray(d["X"])
    XT = X.T
    Xp = jnp.pad(X, ((0, B), (0, 0)))
    XTp = jnp.pad(XT, ((0, 0), (0, B)))
    cols = d["cols"]
    out = []
    for i in range(T):
        blk = cols[R * i: R * (i + 1)]
        if name == "g0_slices":
            acc = jnp.zeros((B, M), jnp.float32)
            for r in range(R):
                for s in range(S):
                    c = int(blk[r, s])
                    acc = acc + X[c * B: c * B + B]
            o = jnp.tile(acc, (R, 1))
        elif name == "g1_slices2x":
            acc = jnp.zeros((2 * B, M), jnp.float32)
            for r in range(R):
                for s in range(S // 2):
                    c = int(blk[r, s])
                    acc = acc + Xp[c * B: c * B + 2 * B]
            o = jnp.tile(acc, (R // 2, 1))
        elif name == "g4_lane_ds":
            acc = jnp.zeros((M, 2 * B), jnp.float32)
            for r in range(R):
                for s in range(S // 2):
                    c = int(blk[r, s])
                    acc = acc + XTp[:, c * B: c * B + 2 * B]
            o = jnp.tile(acc, (1, S))
        elif name == "g2_taa0":
            g = jnp.take_along_axis(
                X[0:P], jnp.asarray(d["idx0"][i * P:(i + 1) * P]), axis=0)
            o = g[0:B] + g[P - B:P]
        elif name == "g3_taa1":
            o = jnp.take_along_axis(
                XT[:, 0:P], jnp.asarray(d["idx1"][i * M:(i + 1) * M]),
                axis=1)
        elif name == "g3w_taa1_wide":
            g = jnp.take_along_axis(
                jnp.asarray(d["XTW"][i * M:(i + 1) * M]),
                jnp.asarray(d["idx1w"][i * M:(i + 1) * M]), axis=1)
            o = g[:, 0:P]
        else:
            o = X[0:R * B]
        out.append(o)
    return np.asarray(jnp.concatenate(out))


def _tensors(d):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    X = t["X"]
    t["Xp"] = torch.nn.functional.pad(X, (0, 0, 0, B))
    t["XT"] = X.T.contiguous()
    t["XTp"] = torch.nn.functional.pad(t["XT"], (0, B))
    return t


def _args(name, t):
    return {"g0_slices": (t["cols"], t["X"]),
            "g1_slices2x": (t["cols"], t["Xp"]),
            "g4_lane_ds": (t["cols"], t["XTp"]),
            "g2_taa0": (t["idx0"], t["X"], P),
            "g3_taa1": (t["idx1"], t["XT"]),
            "g3w_taa1_wide": (t["idx1w"], t["XTW"], P),
            "g5_floor": (t["X"], T)}[name]


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_probe_body(data, name):
    """Each wrapper on CPU tensors (its plain version) against the probe
    body in jnp: the gathers and g5 bit for bit, the slice sums (g0, g1,
    g4) within 1e-5 of max|ref|, the probe's own bound (the reference adds
    1,024 or 512 f32 slices one after another, torch sums them pairwise;
    g0 differs by 1.0e-6 of max)."""
    gpr.reset_counts()
    got = getattr(gpr, name)(*_args(name, _tensors(data))).numpy()
    want = _reference(name, data)
    assert got.shape == want.shape
    if name in ("g0_slices", "g1_slices2x", "g4_lane_ds"):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)
    c = gpr.counts()
    assert c[f"{name}_ref"] == 1 and sum(c.values()) == 1


def test_inputs_are_the_reference_draws():
    """make_inputs draws the reference's six arrays in its order
    (exp_gather.py:64-196), the ones a run leaves unused included."""
    d = exp_gather.make_inputs(T, S)
    nbr = T * R
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        d["cols"], rng.integers(0, nbr, size=(nbr, S), dtype=np.int32))
    np.testing.assert_array_equal(d["X"], np.asarray(jnp.asarray(
        rng.standard_normal((nbr * B, M)), jnp.float32)))
    for key, hi, shape in (("idx0", P, (T * P, M)), ("idx1", P, (T * M, P)),
                           ("idx1w", W, (T * M, W))):
        np.testing.assert_array_equal(
            d[key], rng.integers(0, hi, size=shape, dtype=np.int32))
    np.testing.assert_array_equal(d["XTW"], np.asarray(jnp.asarray(
        rng.standard_normal((T * M, W)), jnp.float32)))


@pytest.mark.parametrize("name", NAMES)
def test_library_call_matches_plain(data, name):
    """Each variant's library call (the one PyTorch call the probe times
    beside its kernel) computes the plain version's function: within its
    stated bound (1e-5 of max|plain|, the embedding_bag sums 1e-4)."""
    t = _tensors(data)
    what, call, as_plain, tol = exp_gather.library(name, t, T, S)
    want = gpr.PLAIN_OF[getattr(gpr, name)](*_args(name, t))
    got = as_plain(call())
    assert what and got.shape == want.shape
    assert (got - want).abs().max() <= tol * want.abs().max()


def test_touched_sectors_counts_distinct_sectors(data):
    """touched_sectors (g3w's bound) against a brute-force count of the
    distinct 32-byte sectors (8 floats) each row's first P indices touch:
    on rows built to repeat indices inside one sector, to hit one sector
    only and to hit every sector of a short row, and on the probe's own
    draws, where it is about 1 - e^-1 of the row's 512 sectors."""
    def brute(idx, P):
        return sum(len({int(v) // 8 for v in row[:P]}) for row in idx)

    idx = np.zeros((3, 24), dtype=np.int32)
    idx[0, :8] = [3, 5, 3, 7, 0, 8, 15, 16]  # sectors {0, 1, 2}
    idx[1] = 9  # one sector
    idx[2, :16] = np.arange(16) * 8  # 16 sectors, the rest sector 0
    for P in (4, 8, 16, 24):
        assert exp_gather.touched_sectors(torch.from_numpy(idx), P) == \
            brute(idx, P)
    assert exp_gather.touched_sectors(torch.from_numpy(idx), 8) == 3 + 1 + 8
    draws = data["idx1w"]
    n = exp_gather.touched_sectors(torch.from_numpy(draws), P)
    assert n == brute(draws, P)
    share = n / (draws.shape[0] * W / 8)
    assert abs(share - (1 - np.exp(-P / (W / 8)))) < 0.01


def _digest(name):
    path = os.path.join(ROOT, name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_probe_on_cpu_writes_only_out(tmp_path, monkeypatch):
    """--device cpu runs the plain versions, times nothing (a CPU has no
    device time), writes its JSON to --out only, and leaves the reference's
    exp_gather_results.json at the root as it was, even when run from the
    root."""
    before = _digest("exp_gather_results.json")
    monkeypatch.chdir(ROOT)
    out = tmp_path / "g.json"
    assert exp_gather.main(["10", "--device", "cpu", "--out", str(out)]) == 0
    assert _digest("exp_gather_results.json") == before
    r = json.loads(out.read_text())
    assert r["device"] == "cpu" and r["T"] == 10 and r["S"] == S
    for name in NAMES:
        assert r[name]["max_abs_err"] == 0.0 and "ms" not in r[name]
        assert r[name]["library"]
    assert r["slice_bytes"] == 10 * R * S * B * M * 4
    assert r["element_bytes"] == 10 * P * M * 4


def test_probe_defaults_to_the_card(monkeypatch, tmp_path):
    """Without --device the probe runs on the card; with none visible it
    raises (no fall-back to the CPU) and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_gather.main(["--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["f64_x", "wide_x", "cols_int64",
                                 "cols_rows", "odd_slots", "idx0_shape",
                                 "idx1_cols", "xtw_shape", "non_contiguous",
                                 "m_not_built"])
def test_wrappers_reject_bad_device_input(bad):
    """A tensor that is not on the CPU takes the kernel path, which checks
    its input before any build or launch (meta tensors stand in for CUDA
    ones); nothing falls back to the plain version."""
    Tm, n = 3, 3 * 128
    X = _meta((n, M))
    Xp = _meta((n + B, M))
    XTp = _meta((M, n + B))
    XT = _meta((M, n))
    cols = _meta((R * Tm, S), torch.int32)
    idx0 = _meta((Tm * P, M), torch.int32)
    idx1 = _meta((Tm * M, P), torch.int32)
    idx1w, XTW = _meta((Tm * M, W), torch.int32), _meta((Tm * M, W))
    if bad == "f64_x":
        X = Xp = _meta((n, M), torch.float64)
        XTp, XT = _meta((M, n + B), torch.float64), _meta((M, n),
                                                           torch.float64)
        XTW = _meta((Tm * M, W), torch.float64)
    elif bad == "wide_x":
        X, Xp = _meta((n, 9)), _meta((n + B, 9))
        XTp, XT = _meta((9, n + B)), _meta((9, n))
    elif bad == "cols_int64":
        cols = _meta((R * Tm, S), torch.int64)
    elif bad == "cols_rows":
        cols = _meta((R * Tm + 3, S), torch.int32)
    elif bad == "odd_slots":
        cols = _meta((R * Tm, S - 1), torch.int32)
    elif bad == "idx0_shape":
        idx0 = _meta((Tm * P + 1, M), torch.int32)
    elif bad == "idx1_cols":
        idx1 = _meta((Tm * M, P - 2), torch.int32)
    elif bad == "xtw_shape":
        XTW = _meta((Tm * M, W - 4))
    elif bad == "non_contiguous":
        X = _meta((M, n)).T
        Xp = _meta((M, n + B)).T
        XTp, XT = _meta((n + B, M)).T, _meta((n, M)).T
        XTW = _meta((W, Tm * M)).T
    calls = {"g0_slices": lambda: gpr.g0_slices(cols, X),
             "g1_slices2x": lambda: gpr.g1_slices2x(cols, Xp),
             "g4_lane_ds": lambda: gpr.g4_lane_ds(cols, XTp),
             "g2_taa0": lambda: gpr.g2_taa0(idx0, X, P),
             "g3_taa1": lambda: gpr.g3_taa1(idx1, XT),
             "g3w_taa1_wide": lambda: gpr.g3w_taa1_wide(idx1w, XTW, P),
             "gather_sum": lambda: gpr.gather_sum(cols, _meta((n, 16)))}
    slices = ["g0_slices", "g1_slices2x", "g4_lane_ds"]
    hit = {"f64_x": NAMES[:-1],
           "wide_x": ["g0_slices", "g1_slices2x", "g2_taa0", "g3_taa1",
                      "g4_lane_ds"],
           "cols_int64": slices, "cols_rows": slices, "odd_slots": slices,
           "idx0_shape": ["g2_taa0"], "idx1_cols": ["g3_taa1"],
           "xtw_shape": ["g3w_taa1_wide"], "non_contiguous": NAMES[:-1],
           "m_not_built": ["gather_sum"]}[bad]
    gpr.reset_counts()
    for name in hit:
        with pytest.raises(ValueError):
            calls[name]()
    assert not any(gpr.counts().values())


@pytest.mark.parametrize("value,ok", [(-1, False), (0, True), (47, True),
                                      (48, False)])
def test_indices_outside_their_source_are_refused(value, ok):
    """The kernels index unchecked, so the wrappers refuse a read block
    column whose slice leaves X (here 3 tiles + 8 rows: c in [0, 47] for
    16-row slices) and an index past its source; an unread slot may hold
    anything. An index that passed is not read again until the tensor
    changes in place."""
    cols = torch.zeros((48, 8), dtype=torch.int32)
    cols[5, 3] = value
    cols[5, 4] = 10**6  # past the S / 2 = 4 slots g1 reads
    if ok:
        gpr.check_cols(cols, 3 * 128 + 8, 4, 2 * B)
        cols[5, 3] = 48
    with pytest.raises(ValueError, match="leave"):
        gpr.check_cols(cols, 3 * 128 + 8, 4, 2 * B)
    idx = torch.zeros((8, 16), dtype=torch.int32)
    idx[2, 5] = value
    if ok:
        gpr.check_range(idx, 47, "idx")
    else:
        with pytest.raises(ValueError, match="leave"):
            gpr.check_range(idx, 47, "idx")


def test_counts_reset(data):
    t = _tensors(data)
    gpr.reset_counts()
    gpr.g0_slices(t["cols"], t["X"])
    gpr.g3_taa1(t["idx1"], t["XT"])
    c = gpr.counts()
    assert c["g0_slices_ref"] == 1 and c["g3_taa1_ref"] == 1
    assert sum(c.values()) == 2
    gpr.reset_counts()
    assert not any(gpr.counts().values())


# ---------------------------------------------------------------------------
# gather_plan: the persistent split of gather_sum's kernel
# ---------------------------------------------------------------------------

PLAN_CASES = [(10, 64, 132, None), (37, 20, 132, None), (37, 20, 132, 10),
              (300, 64, 132, 32), (298, 64, 132, None), (1, 4, 132, None),
              (5, 8, 7, 4)]  # (T, S, sms, slots read)


def _cols(T, S, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, T * R + 1, (T * R, S)).astype(
        np.int32))


@pytest.mark.parametrize("T,S,sms,slots", PLAN_CASES)
def test_gather_plan_ranges_cover_every_slot_once(T, S, sms, slots):
    """The ranges tile the T R slots' list in order: they start at 0, end
    at T n, are multiples of the 4-slot group and none is empty; the
    kernel's block_of gives each slot the range that holds it, and a cut
    tile's pieces are the blocks from block_of(first) to block_of(last)."""
    plan = gpr.gather_plan(_cols(T, S), 8, sms, slots=slots)
    r = plan.ranges()
    total = T * R * plan.slots
    assert r[0] == 0 and r[-1] == total and len(r) == plan.grid + 1
    assert np.all(r % gpr.GROUP == 0) and np.all(np.diff(r) > 0)
    assert plan.grid == min(gpr.SUM_BLOCKS * sms, total // 4)
    e = np.arange(total)
    owner = np.searchsorted(r, e, side="right") - 1
    np.testing.assert_array_equal(plan.block_of(e), owner)
    hits = np.zeros(total, np.int64)
    for b in range(plan.grid):
        hits[r[b]:r[b + 1]] += 1
    assert np.all(hits == 1)


@pytest.mark.parametrize("T,S,sms,slots", PLAN_CASES)
def test_gather_plan_block_loads_are_even(T, S, sms, slots):
    """Every block's slot count lies within one 4-slot group of every
    other's: no SM is more than a group over the mean."""
    plan = gpr.gather_plan(_cols(T, S), 8, sms, slots=slots)
    loads = np.diff(plan.ranges())
    assert loads.max() - loads.min() <= gpr.GROUP


@pytest.mark.parametrize("T,S,slots", [(10, 64, None), (37, 20, 10),
                                       (12, 16, 8)])
def test_gather_plan_unions_are_numpy_unique(T, S, slots):
    """The plan's union sizes are numpy.unique's count of each tile's
    block columns (the first `slots` of its R rows), on random and on
    repeating columns."""
    for cols in (_cols(T, S), _cols(T, S) % 5):
        plan = gpr.gather_plan(cols, 8, 132, slots=slots)
        k = plan.slots
        want = [len(np.unique(cols[R * t:R * (t + 1), :k].numpy()))
                for t in range(T)]
        assert list(gpr.tile_unions(cols, k)) == want
        s = plan.summary(cols)
        assert s["union_bytes"] == sum(want) * 4 * B * 8
        assert s["unions"]["max"] == max(want) and "unions" not in \
            plan.summary()


@pytest.fixture(scope="module")
def brick24_cols():
    from maxwell_tpu_torch.problems import BrickCavity3D
    from maxwell_tpu_torch.sparse.bsr import BSRMatrix
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    cav = PermutedProblem(BrickCavity3D(nx=24, ny=24, nz=24))
    return BSRMatrix.from_csr(cav.K, block=8, device="cpu").cols


@pytest.mark.parametrize("m", gpr.SLICE_MS)
def test_gather_plan_stages_the_rcm_layout(brick24_cols, m):
    """v4_gather's 24^3 RCM layout (124 distinct block columns of a tile's
    1,024 slots on average) on the persistent grid of two blocks an SM,
    its slots within one group of even; the summary records what staging
    each tile's union once would read beside what the slots read (at most
    half: the kernel reads every slot, L1 serving the repeats)."""
    plan = gpr.gather_plan(brick24_cols, m, 132)
    s = plan.summary(brick24_cols)
    assert plan.grid == 264 and s["unions"]["max"] == 247
    assert plan.m == m and plan.n == 1024
    assert s["block_slots"]["max"] - s["block_slots"]["min"] <= gpr.GROUP
    assert s["bytes_slices"] == plan.T * 1024 * 8 * m * 4
    assert s["union_bytes"] <= 0.5 * s["bytes_slices"]


@pytest.mark.parametrize("rows,slots,transposed", [(8, None, False),
                                                   (16, 32, False),
                                                   (16, 32, True)])
def test_gather_plan_streams_the_probe_draws(rows, slots, transposed):
    """g0, g1 and g4 on make_inputs(298, 64): about 90% of a tile's slots
    distinct, so the unions' slices are nearly all the slots read; 264
    blocks, every one within a group of the others' slot count."""
    cols = torch.from_numpy(exp_gather.make_inputs(298, 64)["cols"])
    plan = gpr.gather_plan(cols, 8, 132, rows, slots, transposed)
    s = plan.summary(cols)
    assert s["unions"]["min"] > 0.85 * plan.n
    assert s["union_bytes"] > 0.85 * s["bytes_slices"]
    assert plan.grid == 264 and s["block_slots"]["max_over_mean_pct"] < 1


def _split_sum(cols, X, plan):
    """gather_sum's arithmetic by the plan: each block's range summed tile
    piece by tile piece (a piece's slices in slot order), a cut tile's
    pieces added in range order, the (8, m) sums tiled R times."""
    T, m, n = plan.T, X.shape[1], plan.n
    c = cols[:, :plan.slots].reshape(-1).long()
    slices = X[:X.shape[0] // B * B].view(-1, B, m)[c]  # slot order
    r = plan.ranges()
    pieces = {}
    for b in range(plan.grid):
        for t in range(r[b] // n, -(-r[b + 1] // n)):
            a, z = max(r[b], t * n), min(r[b + 1], (t + 1) * n)
            acc = torch.zeros((B, m), dtype=X.dtype)
            for e in range(a, z):
                acc = acc + slices[e]
            pieces.setdefault(t, []).append(acc)
    out = []
    for t in range(T):
        s = pieces[t][0]
        for p in pieces[t][1:]:
            s = s + p
        out.append(s.repeat(R, 1))
    return torch.cat(out)


@pytest.mark.parametrize("sms", [132, 4, 3])
def test_gather_split_matches_plain_and_probe_body(data, sms):
    """The split's arithmetic (range pieces, combined in range order) on
    the probe's draws at T 10 agrees with sum_plain and with the probe's
    g0 body (jnp, per grid step) within 1e-5 of max|ref|; at every SM
    count some tiles are cut between ranges."""
    t = _tensors(data)
    plan = gpr.gather_plan(t["cols"], M, sms)
    assert plan.cut_tiles() > 0
    got = _split_sum(t["cols"], t["X"], plan)
    want = gpr.sum_plain(t["cols"], t["X"])
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    ref = _reference("g0_slices", data)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_profile_shift_gather_needs_the_card(monkeypatch, tmp_path):
    """The two kernels' profile times them: without a visible card it
    raises and writes nothing; asked for the CPU it refuses."""
    from maxwell_tpu_torch.bench import profile_shift_gather

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_shift_gather.main(["--out", str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()
    with pytest.raises(RuntimeError, match="needs the card"):
        profile_shift_gather.run(device="cpu")
