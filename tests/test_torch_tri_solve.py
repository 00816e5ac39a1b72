"""Level-scheduled triangular solves of maxwell_tpu_torch
(kernels/tri_solve.py) against the JAX package's (maxwell_tpu/kernels/
tri_solve.py) on the CPU, where the wrapper runs its plain version: the
LevelSchedule arrays of splu's L/U and the LDL^T L/L^T of config 3's 16x16
rectangle at sigma 45 equal the reference's; the per-factor and factored
solves match the reference's solves (f64 to 1e-12 relative to max|x|; f32
to 1e-5, or to 4 times the reference's own f32 error where that is
larger) and scipy (f64 to 1e-12) at m 1 and 4. The CUDA kernel's compact
plan (csrc/tri_solve.cu) against the padded layout, its summation order
emulated in numpy against the plain version, and its ring hand-off walked
under random warp schedules."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from maxwell_tpu.kernels import tri_solve as ref_tri
from maxwell_tpu.problems import RectCavity2D
from maxwell_tpu_torch.kernels import tri_solve

torch.set_num_threads(1)

SIGMA = 45.0
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NP = {torch.float64: np.float64, torch.float32: np.float32}


@pytest.fixture(scope="module")
def shifted():
    cav = RectCavity2D(nx=16, ny=16)
    return (cav.K - SIGMA * cav.M).tocsr()


@pytest.fixture(scope="module")
def factors(shifted):
    """{name: (port LevelSchedule, reference LevelSchedule, host CSR)} of
    splu's L and U and the LDL^T's L and L^T, at f64 on the CPU."""
    lu = spla.splu(shifted.tocsc())
    p_lu = tri_solve.SparseLUDevice.from_splu(lu, device="cpu")
    r_lu = ref_tri.SparseLUDevice.from_splu(lu)
    p_ld = tri_solve.SparseLDLTDevice.factor(shifted, device="cpu")
    r_ld = ref_tri.SparseLDLTDevice.factor(shifted)
    return {
        "splu_L": (p_lu.L, r_lu.L, lu.L.tocsr()),
        "splu_U": (p_lu.U, r_lu.U, lu.U.tocsr()),
        "ldlt_L": (p_ld.L, r_ld.L, None),
        "ldlt_Lt": (p_ld.Lt, r_ld.Lt, None),
    }


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(
        np.asarray(want)).max()


def _ref_cast(obj, dtype):
    """The reference's solver object with its values in dtype (its own
    from_csr keeps the CSR's f64): every float leaf cast."""
    def cast(v):
        if isinstance(v, ref_tri.LevelSchedule):
            return _ref_cast(v, dtype)
        if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating):
            return jnp.asarray(v, dtype=dtype)
        return v

    return dataclasses.replace(obj, **{f.name: cast(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})


@pytest.mark.parametrize("name", ["splu_L", "splu_U", "ldlt_L", "ldlt_Lt"])
def test_level_schedule_arrays_equal_the_reference(factors, name):
    port, ref, _ = factors[name]
    assert port.n == ref.n and port.lower == ref.lower
    for f in ("rows", "cols", "vals", "diag"):
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.shape == want.shape and np.array_equal(got, want), f
    # the port's live counts agree with the padding they skip
    n = port.n
    assert np.array_equal(port.live.numpy(), (port.rows < n).sum(1).numpy())
    assert np.array_equal(port.cnt.numpy(), (port.cols < n).sum(2).numpy())
    assert port.dinv[-1] == 1.0


def test_ldlt_factor_is_a_chain(factors):
    """After RCM the LDL^T factor is a chain: one row a level, (480, 1,
    31) at 16x16."""
    L = factors["ldlt_L"][0]
    assert tuple(L.cols.shape) == (480, 1, 31)
    assert L.live.max() == 1


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("name", ["splu_L", "splu_U", "ldlt_L", "ldlt_Lt"])
def test_level_solve_plain_matches_reference(factors, name, m):
    port, ref, csr = factors[name]
    rng = np.random.default_rng(m)
    B = rng.standard_normal((port.n, m))
    tri_solve.reset_counts()
    got = tri_solve.level_solve(port, torch.from_numpy(B))
    assert tri_solve.counts() == {"level_solve": 0, "level_solve_plain": 1}
    assert _rel(got, ref.solve(jnp.asarray(B))) <= TOL[torch.float64]
    if csr is not None:
        want = spla.spsolve_triangular(csr, B, lower=port.lower)
        assert _rel(got, want) <= TOL[torch.float64]
    x = tri_solve.level_solve(port, torch.from_numpy(B[:, 0]))
    assert x.shape == (port.n,)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["splu", "ldlt"])
def test_factored_solve_matches_reference_and_scipy(shifted, kind, dtype, m):
    rng = np.random.default_rng(10 + m)
    B = rng.standard_normal((shifted.shape[0], m))
    if kind == "splu":
        lu = spla.splu(shifted.tocsc())
        port = tri_solve.SparseLUDevice.from_splu(lu, dtype=dtype,
                                                  device="cpu")
        ref = ref_tri.SparseLUDevice.from_splu(lu)
    else:
        port = tri_solve.SparseLDLTDevice.factor(shifted, dtype=dtype,
                                                 device="cpu")
        ref = ref_tri.SparseLDLTDevice.factor(shifted)
    got = port.solve(torch.from_numpy(B).to(dtype))
    assert got.dtype == dtype and got.shape == B.shape
    want = ref.solve(jnp.asarray(B))
    tol = TOL[dtype]
    if dtype == torch.float32:
        # the reference's own f32 solve is off its f64 solve by 2e-6 (splu)
        # to 2e-5 (LDL^T, no pivoting: the rounding grows along the chain of
        # 480 levels); two f32 solves that sum in other orders differ by as
        # much, so the bound is 1e-5 or 4 times the reference's own f32
        # error, whichever is larger
        want32 = _ref_cast(ref, np.float32).solve(
            jnp.asarray(B, dtype=np.float32))
        tol = max(tol, 4 * _rel(want32, want))
        want = want32
    assert _rel(got, want) <= tol
    if dtype == torch.float64:
        want = spla.spsolve(shifted.tocsc(), B).reshape(B.shape)
        assert _rel(got, want) <= TOL[dtype]
    if m == 1:
        assert port.solve(torch.from_numpy(B[:, 0]).to(dtype)).shape == (
            shifted.shape[0],)


def _random_factor(lower):
    """The reference's own random factors (tests/unit/test_tri_solve.py):
    (rng, T) with T lower (n 80) or upper (n 60) triangular."""
    rng = np.random.default_rng(3 if lower else 4)
    n = 80 if lower else 60
    T = sp.random(n, n, density=0.05, random_state=3 if lower else 4).tolil()
    T[np.arange(n), np.arange(n)] = 1.0 if lower else 2.0 + rng.random(n)
    return rng, (sp.tril if lower else sp.triu)(T.tocsr()).tocsr()


@pytest.mark.parametrize("lower", [True, False])
def test_random_triangular_matches_scipy(lower):
    """The reference's own random-factor checks (tests/unit/
    test_tri_solve.py) through the port's schedule."""
    rng, T = _random_factor(lower)
    n = T.shape[0]
    S = tri_solve.LevelSchedule.from_csr(T, lower=lower, device="cpu")
    B = rng.standard_normal((n, 3))
    got = tri_solve.level_solve(S, torch.from_numpy(B))
    want = spla.spsolve_triangular(T, B, lower=lower)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    ref = ref_tri.LevelSchedule.from_csr(T, lower=lower)
    assert S.n_levels == ref.n_levels


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["splu_L", "splu_U", "ldlt_L", "ldlt_Lt"])
def test_backward_error_separates_solves_from_perturbed_ones(factors, name,
                                                             dtype):
    """backward_error, the card's gate for the kernel, is under its bound
    of 2 for the plain version's solves and far above it for a solution
    off by 1e-4 relative."""
    port, _, _ = factors[name]
    S = dataclasses.replace(port, vals=port.vals.to(dtype),
                            diag=port.diag.to(dtype),
                            dinv=port.dinv.to(dtype))
    B = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (S.n, 4))).to(dtype)
    X = tri_solve.level_solve(S, B)
    assert tri_solve.backward_error(S, B, X) <= 2
    assert tri_solve.backward_error(S, B, X * (1 + 1e-4)) > 2


# ---------------------------------------------------------------------------
# The kernel's compact plan (csrc/tri_solve.cu): positions in solve order
# ---------------------------------------------------------------------------

PLAN_FACTORS = ["splu_L", "splu_U", "ldlt_L", "ldlt_Lt", "random_L",
                "random_U", "banded_L"]


def _banded_factor(n=600):
    """A unit lower factor whose row i reads rows i - 20 .. i - 10: levels
    of ten independent rows, window 20, so the kernel's warps may run ahead
    of each other and its ring (64 entries) is reused nine times."""
    rng = np.random.default_rng(7)
    i = np.repeat(np.arange(n), 11)
    j = i - np.tile(np.arange(10, 21), n)
    keep = j >= 0
    T = sp.csr_matrix((0.1 * rng.standard_normal(keep.sum()),
                       (i[keep], j[keep])), shape=(n, n))
    return (T + sp.eye(n)).tocsr()


@pytest.fixture(scope="module")
def plans(factors):
    """{name: f64 LevelSchedule on the CPU} of config 3's four factors, the
    reference's two random factors and the banded one."""
    out = {name: f[0] for name, f in factors.items()}
    for lower, name in ((True, "random_L"), (False, "random_U")):
        out[name] = tri_solve.LevelSchedule.from_csr(
            _random_factor(lower)[1], lower=lower, device="cpu")
    out["banded_L"] = tri_solve.LevelSchedule.from_csr(
        _banded_factor(), lower=True, device="cpu")
    return out


def _np(S, *names):
    return [getattr(S, f).numpy() for f in names]


def _cast(S, dtype):
    """S with its values in dtype."""
    return dataclasses.replace(S, **{f: getattr(S, f).to(dtype) for f in (
        "vals", "diag", "dinv", "dval", "pdinv")})


@pytest.mark.parametrize("name", PLAN_FACTORS)
def test_compact_plan_holds_every_live_slot_once(plans, name):
    """Every live slot of the padded layout is in the compact streams
    once, with its value; each dependency's position is below its row's,
    ascending within a row; the window is the brute-force maximum; the
    ring covers the window plus the warps in flight; the tail is every slot
    within TAIL positions of its row."""
    S = plans[name]
    n = S.n
    rows, cols, vals, cnt, live = _np(S, "rows", "cols", "vals", "cnt",
                                      "live")
    order, ptr, dep, dval, tail = _np(S, "order", "ptr", "dep", "dval",
                                      "tail")
    # solve order: level by level, a level's live rows as the layout has
    assert np.array_equal(order, np.concatenate(
        [rows[lv, :live[lv]] for lv in range(S.n_levels)]))
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    keep = np.arange(cols.shape[2]) < cnt[..., None]
    r_ = np.broadcast_to(rows[..., None], cols.shape)[keep]
    c_, v_ = cols[keep], vals[keep]
    p_ = np.repeat(np.arange(n), np.diff(ptr))
    assert len(dep) == len(dval) == int(cnt.sum()) == ptr[-1]
    assert sorted(zip(order[p_].tolist(), order[dep].tolist(),
                      dval.tolist())) == sorted(zip(r_.tolist(),
                                                    c_.tolist(),
                                                    v_.tolist()))
    assert np.all(dep < p_)
    assert np.all(np.diff(dep)[p_[1:] == p_[:-1]] > 0)
    assert S.window == (int((pos[r_] - pos[c_]).max()) if len(c_) else 0)
    for dt in (torch.float32, torch.float64):
        ring = S.ring(dt)
        assert S.route(dt) == "shared"
        assert ring & (ring - 1) == 0
        assert ring >= S.window + tri_solve.WARPS > S.window + tri_solve.TAIL
        assert (ring * (torch.finfo(dt).bits // 8 + 4)
                + tri_solve.stage_bytes(dt) <= tri_solve.SMEM_MAX)
    in_tail = np.arange(len(dep)) >= tail[p_]
    assert np.array_equal(in_tail, dep >= p_ - tri_solve.TAIL)
    assert np.all(tail >= ptr[:-1])
    assert np.all(ptr[1:] - tail <= tri_solve.TAIL)
    assert torch.equal(S.pdinv, S.dinv[:n][S.order.long()])


def test_wide_window_takes_the_global_route():
    """A chain whose last row reads the first: its ring of x and tags does
    not fit in shared memory at either dtype, so the kernel keeps them in
    device memory; config 3's and the 128^2 chains' windows fit."""
    n = 20_000
    T = (sp.eye(n) + sp.diags([0.5], [-1], shape=(n, n))
         + sp.csr_matrix(([0.25], ([n - 1], [0])), shape=(n, n))).tocsr()
    S = tri_solve.LevelSchedule.from_csr(T, lower=True, device="cpu")
    assert S.window == n - 1
    for dt in (torch.float32, torch.float64):
        assert S.ring(dt) == 0 and S.route(dt) == "global"


def _kernel_order(S, B):
    """X = T^-1 B summed as csrc/tri_solve.cu sums, in numpy in S.dval's
    dtype: lane l adds its old slots l, l + 32, ... in order, the shuffle
    tree (offsets 16, 8, 4, 2, 1) combines the lanes into lane 0, which
    then adds the tail slots in order; x = (b - acc) / diag."""
    order, ptr, dep, dval, tail, pdinv = _np(S, "order", "ptr", "dep",
                                             "dval", "tail", "pdinv")
    x = np.zeros_like(B)  # by position
    for p in range(S.n):
        lanes = np.zeros((32, B.shape[1]), dtype=B.dtype)
        old = np.arange(ptr[p], tail[p])
        for at in range(0, len(old), 32):
            s = old[at:at + 32]
            lanes[:len(s)] += dval[s, None] * x[dep[s]]
        for off in (16, 8, 4, 2, 1):
            lanes[:off] = lanes[:off] + lanes[off:2 * off]
        acc = lanes[0]
        for s in range(tail[p], ptr[p + 1]):
            acc = acc + dval[s] * x[dep[s]]
        x[p] = (B[order[p]] - acc) * pdinv[p]
    X = np.empty_like(x)
    X[order] = x
    return X


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", PLAN_FACTORS)
def test_kernel_summation_order_matches_plain(plans, name, dtype, m):
    """The kernel's fixed order (old slots in the tree order, then the
    tail), emulated on the CPU at m 1 and 3: within 1e-12 of max|x| of the
    plain version at f64; at f32 within max(16 g, 8) eps max|x|, g the
    chain's rounding growth (the plain f32 solve's distance from the f64
    one over eps max|x|), the gate the card holds the kernel to; and a
    backward error within the substitution bound."""
    S64 = plans[name]
    S = _cast(S64, dtype)
    B64 = np.random.default_rng(11 + m).standard_normal((S.n, m))
    B = torch.from_numpy(B64).to(dtype)
    got = torch.from_numpy(_kernel_order(S, B.numpy()))
    want = tri_solve.level_solve_plain(S, B)
    scale = want.abs().max().item()
    if dtype == torch.float64:
        tol = TOL[dtype] * scale
    else:
        p64 = tri_solve.level_solve_plain(S64, torch.from_numpy(B64))
        eps = torch.finfo(torch.float32).eps
        growth = ((want.double() - p64).abs().max().item()
                  / (eps * p64.abs().max().item()))
        tol = max(16 * growth, 8) * eps * scale
    assert (got - want).abs().max().item() <= tol
    assert tri_solve.backward_error(S, B, got) <= 2


def _walk(S, seed):
    """csrc/tri_solve.cu's walk on the shared ring, its warps stepped in a
    random order, one step a slot read: each warp waits until every row at
    or before p - TAIL - 1 is published (one tag a warp), reads its old slots,
    waits on and reads each tail slot, then writes its ring entry and tag.
    Raises if no warp can step before every row is published, if a read
    finds its entry holding another position, or if a tag would shrink."""
    rng = np.random.default_rng(seed)
    ptr, dep, tail = _np(S, "ptr", "dep", "tail")
    n, k, W = S.n, tri_solve.TAIL, tri_solve.WARPS
    ring = S.ring(torch.float64)
    mask = ring - 1
    tags = np.full(ring, -1)
    # each warp: [position, phase (0 wait, 1 old, 2 tail, 3 publish), slot]
    warps = [[w, 0, 0] for w in range(W)]

    def ready(q):
        return q < 0 or tags[q & mask] >= q

    def can_step(w):
        p, phase, s = w
        if p >= n:
            return False
        if phase == 0:
            return all(ready(p - k - 1 - lane) for lane in range(W))
        if phase == 2 and s < ptr[p + 1]:
            return ready(dep[s])
        return True

    while True:
        live = [w for w in warps if can_step(w)]
        if not live:
            assert all(w[0] >= n for w in warps), "the walk deadlocked"
            return
        w = live[rng.integers(len(live))]
        p, phase, s = w
        if phase == 0:
            w[1:] = [1, ptr[p]]
        elif phase in (1, 2):
            end = tail[p] if phase == 1 else ptr[p + 1]
            if s < end:
                assert tags[dep[s] & mask] == dep[s], "entry overwritten"
                w[2] = s + 1
            else:
                w[1] = phase + 1
        else:
            assert tags[p & mask] < p
            tags[p & mask] = p
            w[:] = [p + W, 0, 0]


@pytest.mark.parametrize("name", ["ldlt_L", "splu_L", "random_U",
                                  "banded_L"])
def test_ring_walk_is_safe_under_random_schedules(plans, name):
    """The kernel's hand-off on its shared ring, stepped in random orders
    (the banded factor's warps run ahead of each other and its ring is
    reused): no deadlock, no entry overwritten before its last read."""
    for seed in range(3):
        _walk(plans[name], seed)


def test_plan_constants_match_the_kernel_source():
    """The plan's WARPS, TAIL and SMEM_MAX are the constants
    csrc/tri_solve.cu is compiled with."""
    import re
    from pathlib import Path

    src = (Path(tri_solve.__file__).parents[1] / "csrc"
           / "tri_solve.cu").read_text()
    for name, want in (("kWarps", tri_solve.WARPS),
                       ("kTail", tri_solve.TAIL),
                       ("kSmemMax", tri_solve.SMEM_MAX)):
        got = re.search(rf"constexpr int {name} = (\d+);", src)
        assert got and int(got.group(1)) == want, name
    assert 0 <= tri_solve.TAIL < tri_solve.WARPS
