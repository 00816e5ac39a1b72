"""The blocked-ELL SpMM probe of maxwell_tpu_torch (kernels/spmm_probes.py,
bench/exp_spmm.py) against the JAX package's probe on the CPU, where the
wrappers run their plain versions.

The reference's probe kernels (maxwell_tpu/bench/exp_spmm.py) are closures
inside main() with no interpret switch (and main() rewrites
exp_spmm_results.json where it runs), so each plain version is held to its
kernel body restated in jnp, per grid step, on the reference's own layout
carried across with BSRMatrix.from_reference: the 5x5x6 RCM brick's K (3
tiles, S 32) at m 8 and 32. The CUDA kernels themselves are tested in
test_torch_cuda.py."""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.sparse.bsr import BSRMatrix as RefBSR
from maxwell_tpu.sparse.bsr import bsr_matmat_ref as jax_bsr_matmat_ref
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.bench import exp_spmm
from maxwell_tpu_torch.bench.timing import torch_csr
from maxwell_tpu_torch.kernels import spmm_probes as spp
from maxwell_tpu_torch.problems import BrickCavity3D
from maxwell_tpu_torch.sparse.bsr import BSRMatrix
from maxwell_tpu_torch.sparse.reorder import PermutedProblem

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
R, B = 16, 8
HI, DE = jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT
NAMES = [fn.__name__ for fn in spp.KERNELS]
DEF = ("v2_panel_def", "v5_batched_def", "v3_stream", "v3b_onedot")


@pytest.fixture(scope="module")
def layout():
    """The reference's layout of the 5x5x6 RCM brick's K and its port."""
    prob = RefPermuted(RefBrick(nx=5, ny=5, nz=6))
    ref = RefBSR.from_csr(prob.K, block=8, dtype=jnp.float32)
    A = BSRMatrix.from_reference(ref, device="cpu")
    assert A.n_brows == 3 * R and A.slots == 32
    return ref, A


def _x(rows, m):
    return np.random.default_rng(m).standard_normal((rows, m)).astype(
        np.float32)


def _bf16(a):
    return a.astype(jnp.bfloat16).astype(jnp.float32)


def _reference(name, ref, X):
    """The variant's kernel body (exp_spmm.py:111-291) per grid step i,
    restated in jnp on the reference's own layout, the tiles' outputs
    stacked. The DEFAULT-precision bodies (v2, v5_def, v3, v3b) take
    bf16-rounded operands and HIGHEST products: the card's bf16 inputs."""
    b, S, nbr = ref.b, ref.slots, ref.n_brows
    blocks2d = jnp.asarray(np.asarray(ref.blocks).transpose(0, 2, 1, 3)
                           .reshape(nbr * b, S * b))
    cols = np.asarray(ref.cols)
    x = jnp.asarray(X)
    bf = name in DEF
    if bf:
        blocks2d, x = _bf16(blocks2d), _bf16(x)
    out = []
    for i in range(nbr // R):
        blk = blocks2d[i * R * b:(i + 1) * R * b]
        c = cols[i * R:(i + 1) * R]

        def panel(r):
            return jnp.concatenate([x[int(c[r, s]) * b:int(c[r, s]) * b + b]
                                    for s in range(S)], axis=0)

        if name in ("v1_panel_hi", "v2_panel_def"):
            o = jnp.concatenate([jnp.dot(blk[r * b:(r + 1) * b], panel(r),
                                         precision=HI) for r in range(R)])
        elif name == "v3_stream":
            xg = x[0:S * b]
            o = jnp.concatenate([jnp.dot(blk[r * b:(r + 1) * b], xg,
                                         precision=HI) for r in range(R)])
        elif name == "v3b_onedot":
            o = jnp.dot(blk, x[0:S * b], precision=HI)
        elif name == "v4_gather":
            acc = jnp.zeros((b, x.shape[1]), jnp.float32)
            for r in range(R):
                for s in range(S):
                    acc = acc + x[int(c[r, s]) * b:int(c[r, s]) * b + b]
            o = jnp.tile(acc, (R, 1))
        else:  # v5_batched_hi, v5_batched_def, v6_smem_hi
            xg = jnp.stack([panel(r) for r in range(R)])
            o = jnp.einsum("rik,rkm->rim", blk.reshape(R, b, S * b), xg,
                           precision=HI).reshape(R * b, -1)
        out.append(o)
    return np.asarray(jnp.concatenate(out))


def _args(name, A, X):
    V = spp.panel_values(A.blocks)
    return exp_spmm.args_of(name, V, A.cols, X)


@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_probe_body(layout, name, m):
    """Each wrapper on CPU tensors (its plain version) against the probe
    body in jnp on the reference's layout, within 1e-5 of max|ref| (f32
    sums of up to 256 products, or of 512 slices for v4, in another
    order)."""
    ref, A = layout
    X = _x(A.n_padded, m)
    spp.reset_counts()
    got = getattr(spp, name)(*_args(name, A, torch.from_numpy(X))).numpy()
    want = _reference(name, ref, X)
    assert got.shape == want.shape == (A.n_padded, m)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    c = spp.counts()
    assert c[f"{name}_ref"] == 1 and sum(c.values()) == 1


@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("name", ["v1_panel_hi", "v5_batched_hi",
                                  "v6_smem_hi"])
def test_hi_plain_matches_reference_bsr_matmat(layout, name, m):
    """The _hi variants compute the reference's own blocked-ELL product
    (maxwell_tpu.sparse.bsr.bsr_matmat_ref) to 1e-5 of max|ref|."""
    ref, A = layout
    X = _x(A.n_padded, m)
    got = getattr(spp, name)(*_args(name, A, torch.from_numpy(X))).numpy()
    want = np.asarray(jax_bsr_matmat_ref(ref, jnp.asarray(X)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_panel_values_is_the_reference_blocks2d(layout):
    """panel_values lays the blocks out as exp_spmm.py:80-85 does."""
    ref, A = layout
    b, S, nbr = ref.b, ref.slots, ref.n_brows
    want = np.asarray(ref.blocks).transpose(0, 2, 1, 3).reshape(
        nbr * b, S * b)
    np.testing.assert_array_equal(spp.panel_values(A.blocks).numpy(), want)


@pytest.fixture(scope="module")
def port_layout():
    prob = PermutedProblem(BrickCavity3D(nx=5, ny=5, nz=6))
    K = prob.K.tocsr()
    return K, BSRMatrix.from_csr(K, block=8, device="cpu")


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("name", NAMES)
def test_library_call_matches_plain(port_layout, name, m):
    """Each variant's library call (the one PyTorch call the probe times
    beside its kernel) computes the plain version's function within its
    stated bound: 1e-5 of max|plain|, 1e-4 for embedding_bag's sums, 1e-2
    for a bf16 output."""
    K, A = port_layout
    X = torch.from_numpy(_x(A.n_padded, m))
    V = spp.panel_values(A.blocks)
    what, call, as_plain, tol = exp_spmm.library(
        name, V, A.cols, X, torch_csr(K, "cpu"), A.n)
    want = spp.PLAIN_OF[getattr(spp, name)](*exp_spmm.args_of(
        name, V, A.cols, X))
    got = as_plain(call())
    assert what and got.shape == want.shape
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("m", [8, 32, 64, 128])
@pytest.mark.parametrize("onedot", [False, True])
def test_stream_panel_staged_at_every_m(onedot, m):
    """v3/v3b stage the whole fixed panel X[0 : 512] in bf16 beside their
    value ring at every m at S 64 (the 24^3 K's slots): 16 S m bytes of
    panel; the ring, the same at every m, holds at least three stages of
    one box per unit of a step (16 units of 16 rows in v3, 2 of 64 rows in
    v3b)."""
    need = spp.stream_smem(64, m, onedot)
    stages, stage = spp.STREAM_RING[onedot]
    assert stages >= 3 and stage == (2 * 8192 if onedot else 16 * 2048)
    assert need == 1024 + stages * stage + 64 * B * m * 2 + 16 * stages
    assert need <= spp.SMEM_LIMIT


@pytest.mark.parametrize("m", [8, 32, 64, 128])
@pytest.mark.parametrize("onedot", [False, True])
def test_stream_refuses_a_panel_past_the_limit(onedot, m):
    """The first S (a multiple of 4) whose panel and ring leave the H100's
    232,448 bytes is refused with ValueError before any build or launch
    (meta tensors stand in for CUDA ones); the S before it fits."""
    S = 4
    while spp.stream_smem(S, m, onedot) <= spp.SMEM_LIMIT:
        S += 4
    assert spp.stream_smem(S - 4, m, onedot) <= spp.SMEM_LIMIT
    V = _meta((R * B, S * B))
    X = _meta((S * B, m))
    wrapper = spp.v3b_onedot if onedot else spp.v3_stream
    spp.reset_counts()
    with pytest.raises(ValueError, match="shared memory"):
        wrapper(V, X)
    assert not any(spp.counts().values())


@pytest.mark.parametrize("m", [8, 32, 64, 128])
def test_panel_ring_staged_at_every_m(monkeypatch, m):
    """v1_panel_hi stages its X slices at every m at S 64 (the 24^3 K's
    slots): each of a block's 8 warps (half a tile) keeps a ring of at least
    two stages of whole slots (8 X rows of m f32) that divide S, within the
    H100's 232,448 bytes; with a limit one byte below its ring, the width is
    refused with ValueError before any build or launch (meta tensors stand
    in for CUDA ones), never taken unstaged."""
    stages, slots = spp.PANEL_RING[m]
    assert stages >= 2 and 64 % slots == 0 and spp.HI_WARPS * 2 == R
    need = spp.panel_smem(m)
    assert need == 8 * stages * slots * B * m * 4 <= spp.SMEM_LIMIT
    monkeypatch.setattr(spp, "SMEM_LIMIT", need - 1)
    V = _meta((R * B, 64 * B))
    cols = _meta((R, 64), torch.int32)
    X = _meta((R * B + B, m))
    spp.reset_counts()
    with pytest.raises(ValueError, match="shared memory"):
        spp.v1_panel_hi(V, cols, X)
    assert not any(spp.counts().values())


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("name", ["v3_stream", "v3b_onedot", "v2_panel_def",
                                  "v5_batched_def"])
def test_stream_library_calls_match_plain(port_layout, name, m):
    """The bf16 variants' two library calls (the stream variants' and the
    _def rungs'): one PyTorch call on the probe's own f32 operands (TF32
    allowed for that call only, the setting restored after) and the same
    on operands rounded to bf16 beforehand; both within 1e-2 of max|plain|
    (the plain product of bf16-rounded operands for the _def rungs)."""
    K, A = port_layout
    X = torch.from_numpy(_x(A.n_padded, m))
    V = spp.panel_values(A.blocks)
    want = spp.PLAIN_OF[getattr(spp, name)](*exp_spmm.args_of(
        name, V, A.cols, X))
    prev = torch.backends.cuda.matmul.allow_tf32
    what, call, as_plain, tol = exp_spmm.library(
        name, V, A.cols, X, torch_csr(K, "cpu"), A.n)
    what2, call2, as_plain2, tol2 = exp_spmm.library_bf16(name, V, A.cols,
                                                          X)
    assert "f32" in what and "bf16" in what2
    for c, ap, t in ((call, as_plain, tol), (call2, as_plain2, tol2)):
        got = ap(c())
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert (got - want).abs().max() <= t * want.abs().max()
    assert torch.backends.cuda.matmul.allow_tf32 == prev


def _digest(name):
    path = os.path.join(ROOT, name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_probe_on_cpu_writes_only_out(tmp_path, monkeypatch):
    """--device cpu runs the plain versions (K8, K11 and K12 beside
    through their own CPU paths), times nothing, writes its JSON to --out
    only, and leaves the reference's exp_spmm_results.json at the root as
    it was, even when run from the root. K12's sum agrees with (K + M) X
    in f64 to 1e-5."""
    before = _digest("exp_spmm_results.json")
    monkeypatch.chdir(ROOT)
    out = tmp_path / "s.json"
    assert exp_spmm.main(["--grid", "5", "--device", "cpu", "--out",
                          str(out)]) == 0
    assert _digest("exp_spmm_results.json") == before
    r = json.loads(out.read_text())
    assert r["device"] == "cpu" and r["grid"] == 5 and r["tiles"] == 2
    for m in spp.MS:
        res = r[f"m{m}"]
        for name in NAMES:
            assert res[name]["max_abs_err"] == 0.0 and "ms" not in res[name]
            assert res[name]["library"]
        for name in ("v2_panel_def", "v5_batched_def"):
            assert 0 < res[name]["rel_err_vs_f32"] < 2e-2
        for name in ("v3_stream", "v3b_onedot", "v2_panel_def",
                     "v5_batched_def"):
            assert res[name]["library_bf16"]
            assert "f32" in res[name]["library"]
        assert res["v0_current"]["max_abs_err"] == 0.0
        assert res["v7_pairs"]["max_abs_err"] == 0.0
        assert res["v9_km"]["rel_err_vs_f64"] < 1e-5


def test_profile_def_needs_the_card(monkeypatch, tmp_path):
    """The _def rungs' profile times kernels: without a visible card it
    raises before any build, and writes nothing."""
    from maxwell_tpu_torch.bench import profile_def

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_def.main(["--out", str(tmp_path / "p.json")])
    with pytest.raises(RuntimeError, match="needs the card"):
        profile_def.run(5, device="cpu")
    assert not (tmp_path / "p.json").exists()


def test_probe_defaults_to_the_card(monkeypatch, tmp_path):
    """Without --device the probe runs on the card; with none visible it
    raises (no fall-back to the CPU) and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_spmm.main(["--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["m_not_built", "f64_v", "slots_not_4",
                                 "rows_not_tiles", "cols_shape",
                                 "cols_int64", "short_x", "non_contiguous"])
def test_wrappers_reject_bad_device_input(bad):
    """A tensor that is not on the CPU takes the kernel path, which checks
    its input before any build or launch (meta tensors stand in for CUDA
    ones); nothing falls back to the plain version."""
    nbr, S, m = 2 * R, 32, 8
    V = _meta((nbr * B, S * B))
    cols = _meta((nbr, S), torch.int32)
    X = _meta((nbr * B, m))
    if bad == "m_not_built":
        X = _meta((nbr * B, 16))
    elif bad == "f64_v":
        V = _meta((nbr * B, S * B), torch.float64)
    elif bad == "slots_not_4":
        V, cols = _meta((nbr * B, 18 * B)), _meta((nbr, 18), torch.int32)
    elif bad == "rows_not_tiles":
        V, cols = _meta((nbr * B - B, S * B)), _meta((nbr - 1, S),
                                                     torch.int32)
    elif bad == "cols_shape":
        cols = _meta((nbr, S - 4), torch.int32)
    elif bad == "cols_int64":
        cols = _meta((nbr, S), torch.int64)
    elif bad == "short_x":
        X = _meta((S * B - 8, m))
    else:
        X = _meta((m, nbr * B)).T
    streams = ("v3_stream", "v3b_onedot")
    hit = {"m_not_built": NAMES, "f64_v": [n for n in NAMES
                                           if n != "v4_gather"],
           "slots_not_4": [n for n in NAMES if n != "v4_gather"],
           "rows_not_tiles": [n for n in NAMES if n != "v4_gather"],
           "cols_shape": [n for n in NAMES if n not in streams
                          and n != "v4_gather"],
           "cols_int64": [n for n in NAMES if n not in streams],
           "short_x": list(streams), "non_contiguous": NAMES}[bad]
    spp.reset_counts()
    for name in hit:
        with pytest.raises(ValueError):
            getattr(spp, name)(*exp_spmm.args_of(name, V, cols, X))
    assert not any(spp.counts().values())


def test_counts_reset(layout):
    _, A = layout
    X = torch.from_numpy(_x(A.n_padded, 8))
    V = spp.panel_values(A.blocks)
    spp.reset_counts()
    spp.v5_batched_hi(V, A.cols, X)
    spp.v3_stream(V, X)
    c = spp.counts()
    assert c["v5_batched_hi_ref"] == 1 and c["v3_stream_ref"] == 1
    assert sum(c.values()) == 2
    spp.reset_counts()
    assert not any(spp.counts().values())


# ---------------------------------------------------------------------------
# The _def rungs' maps (csrc/spmm_probes.cu def_direct_kernel and
# union_def_kernel), emulated in torch lane by lane: which X elements and
# values each lane of a warp holds in its mma.sync m16n8k16 registers, the
# product those registers make under PTX's fragment layout, and where each
# lane stores its sums. The kernels themselves run in test_torch_cuda.py.
# ---------------------------------------------------------------------------

LG = torch.arange(8)[:, None]  # lane g = lane / 4
LT = torch.arange(4)[None, :]  # lane t = lane % 4


def _fragment_index():
    """(A rows, A cols, B rows, B cols, D rows, D cols) of each lane
    register half, as PTX lays out m16n8k16: A (8 g, 4 t, 4 regs, 2), B
    (8, 4, 2, 2), D (8, 4, 4)."""
    g = torch.arange(8)[:, None, None, None]
    t = torch.arange(4)[None, :, None, None]
    reg = torch.arange(4)[None, None, :, None]
    e = torch.arange(2)[None, None, None, :]
    a_row = (g + 8 * (reg % 2)).expand(8, 4, 4, 2)
    a_col = (2 * t + e + 8 * (reg // 2)).expand(8, 4, 4, 2)
    b_row = (2 * t + e + 8 * reg[..., :2, :]).expand(8, 4, 2, 2)
    b_col = g.expand(8, 4, 2, 2)
    d_row = (g[..., 0] + 8 * (reg[..., 0] // 2)).expand(8, 4, 4)
    d_col = (2 * t[..., 0] + reg[..., 0] % 2).expand(8, 4, 4)
    return [i.reshape(-1) for i in (a_row, a_col, b_row, b_col, d_row,
                                    d_col)]


FRAG = _fragment_index()


def _mma(d, a, b):
    """d (N, 8, 4, 4) += the m16n8k16 product of A registers a (N, 8, 4,
    4, 2) and B registers b (N, 8, 4, 2, 2), in f64."""
    N = a.shape[0]
    A = torch.zeros((N, 16, 16), dtype=torch.float64)
    Bm = torch.zeros((N, 16, 8), dtype=torch.float64)
    A[:, FRAG[0], FRAG[1]] = a.reshape(N, -1).double()
    Bm[:, FRAG[2], FRAG[3]] = b.reshape(N, -1).double()
    D = torch.bmm(A, Bm)
    return d + D[:, FRAG[4], FRAG[5]].reshape(N, 8, 4, 4)


def _b_regs(V, S, ks):
    """Lane (g, t)'s B registers of step ks: its value row g's float4 at
    column 16 ks + 4 t, (.x, .y) and (.z, .w)."""
    nbr = V.shape[0] // B
    Vr = V.bfloat16().float().view(nbr, B, S * B)
    cols = 16 * ks + 4 * LT + torch.arange(4)[:, None, None]  # (4, 1, 4)
    v = Vr[:, :, cols[:, 0, :]]  # (nbr, 8 g, 4 j, 4 t)
    v = v.permute(0, 1, 3, 2)  # (nbr, 8, 4 t, 4 j)
    return v.reshape(nbr, 8, 4, 2, 2)


def _regs_from_quads(f):
    """A registers of tiles 2 i (lo) and 2 i + 1 (hi) from the lane's four
    rows' float4s f (..., 4 rows, 4 columns): pack_tiles."""
    lo = torch.stack([torch.stack([f[..., 0, j], f[..., 1, j]], -1)
                      if r < 2 else
                      torch.stack([f[..., 2, j], f[..., 3, j]], -1)
                      for r, j in ((0, 0), (1, 1), (2, 0), (3, 1))], -2)
    hi = torch.stack([torch.stack([f[..., 0, j], f[..., 1, j]], -1)
                      if r < 2 else
                      torch.stack([f[..., 2, j], f[..., 3, j]], -1)
                      for r, j in ((0, 2), (1, 3), (2, 2), (3, 3))], -2)
    return lo, hi


def _store(Y, writes, r_rows, col0, lo, hi=None):
    """Lane (g, t)'s stores of rows 2 t, 2 t + 1: store_tiles at columns
    col0 (N, 8, 4) .. + 3 from tiles lo and hi, or (hi None) the W-8 pair
    (d0, d2) / (d1, d3) at col0 .. + 1."""
    for row_off, k in ((0, 0), (1, 1)):
        rows = (r_rows[:, None, None] * B + 2 * LT + row_off).expand_as(col0)
        vals = [lo[..., k], lo[..., k + 2]]
        if hi is not None:
            vals += [hi[..., k], hi[..., k + 2]]
        for j, val in enumerate(vals):
            Y[rows, col0 + j] = val.float()
            writes[rows, col0 + j] += 1


def emulate_v5_def(V, cols, X):
    """(Y, writes) of def_direct_kernel: lane (g, t) loads its four k rows
    of a step as a float4 each per 32 columns (m 8: column g alone, the
    m16 rows 8 .. 15 zero), packs tiles 2 i, 2 i + 1, and stores float4s
    at column 32 i + 4 g."""
    nbr, S = cols.shape
    m = X.shape[1]
    Xb = X.bfloat16().float()
    MT = max(1, m // 16)
    d = [torch.zeros((nbr, 8, 4, 4), dtype=torch.float64)
         for _ in range(MT)]
    for ks in range(S // 2):
        c = cols[:, 2 * ks + (LT >> 1)].long()  # (nbr, 1, 4)
        rows = (8 * c + 4 * (LT & 1))[..., None] + torch.arange(4)
        rows = rows.expand(nbr, 8, 4, 4)  # (nbr, g, t, q)
        b = _b_regs(V, S, ks)
        if m == 8:
            x = Xb[rows, LG[..., None].expand(nbr, 8, 4, 4)]
            z = torch.zeros_like(x[..., 0])
            a = torch.stack([torch.stack([x[..., 0], x[..., 1]], -1),
                             torch.stack([z, z], -1),
                             torch.stack([x[..., 2], x[..., 3]], -1),
                             torch.stack([z, z], -1)], -2)
            d[0] = _mma(d[0], a, b)
            continue
        for i in range(m // 32):
            colq = (32 * i + 4 * LG[..., None, None]
                    + torch.arange(4))  # (8, 1, 1, 4)
            f = Xb[rows[..., None], colq.expand(nbr, 8, 4, 4, 4)]
            lo, hi = _regs_from_quads(f)
            d[2 * i] = _mma(d[2 * i], lo, b)
            d[2 * i + 1] = _mma(d[2 * i + 1], hi, b)
    Y = torch.full((nbr * B, m), float("nan"))
    writes = torch.zeros((nbr * B, m), dtype=torch.int32)
    r = torch.arange(nbr)
    if m == 8:
        col0 = LG.expand(8, 4)[None].expand(nbr, 8, 4)
        for row_off, k in ((0, 0), (1, 1)):
            rows = (r[:, None, None] * B + 2 * LT + row_off).expand(nbr, 8, 4)
            Y[rows, col0] = d[0][..., k].float()
            writes[rows, col0] += 1
        return Y, writes
    for i in range(m // 32):
        col0 = (32 * i + 4 * LG).expand(8, 4)[None].expand(nbr, 8, 4)
        _store(Y, writes, r, col0, d[2 * i], d[2 * i + 1])
    return Y, writes


def emulate_union_map(cols, x_rows):
    """Per unit of 8 block rows, as union_def_kernel builds it: the bitmap
    over X's x_rows / 8 block columns in 32-bit words, each word's prefix
    popcount, the union's columns word by word (ucol) and each of the
    unit's 8 S slots' place. Returns [(ucol, places)] by unit."""
    nwords = -(-(x_rows // B) // 32)
    bit = torch.arange(32)
    out = []
    for unit in cols.reshape(cols.shape[0] // 8, -1).long():
        # atomicOr of bit c % 32 into word c / 32: the same words in any
        # order
        flags = torch.zeros((nwords, 32), dtype=torch.bool)
        flags[unit >> 5, unit & 31] = True
        words = (flags.long() << bit).sum(1)
        pop = ((words[:, None] >> bit) & 1).sum(1)
        prefix = torch.cumsum(pop, 0) - pop
        # word w's set bits in order from place prefix[w]
        ucol = torch.full((int(pop.sum()),), -1, dtype=torch.int64)
        rank = torch.cumsum(flags.long(), 1) - flags.long()
        ucol[(prefix[:, None] + rank)[flags]] = (
            32 * torch.arange(nwords)[:, None] + bit)[flags]
        below = words[unit >> 5] & ((1 << (unit & 31)) - 1)
        places = prefix[unit >> 5] + ((below[:, None] >> bit) & 1).sum(1)
        out.append((ucol, places))
    return out


def emulate_v2_def(V, cols, X, W):
    """(Y, writes) of union_def_kernel at pass width W: per unit and pass,
    the panel staged item by item (rows 4 h .. 4 h + 3 of entry u at
    columns 4 qd .. + 3 into chunks 4 qd + h and 4 qd + 2 + h), each lane
    reading its chunks through its slots' places (W 32: pairs 2 g + half
    first, then the other; W 8: pair g % 4), the products of each half of
    a row's steps (its two warps) added first half + second, the stores."""
    nbr, S = cols.shape
    m = X.shape[1]
    Xb = X.bfloat16().float()
    Y = torch.full((nbr * B, m), float("nan"))
    writes = torch.zeros((nbr * B, m), dtype=torch.int32)
    MT = max(1, W // 16)
    for unit, (ucol, places) in enumerate(emulate_union_map(cols,
                                                           X.shape[0])):
        nu = ucol.numel()
        r = unit * 8 + torch.arange(8)
        pl = places.view(8, S)
        for j0 in range(0, m, W):
            panel = torch.full((nu, W, 4, 2), float("nan"))
            for u in range(nu):
                for qd in range(W // 4):
                    for h in range(2):
                        f = Xb[8 * ucol[u] + 4 * h + torch.arange(4),
                               j0 + 4 * qd: j0 + 4 * qd + 4]
                        lo, hi = _regs_from_quads(f)
                        panel[u, 4 * qd + h] = lo
                        panel[u, 4 * qd + 2 + h] = hi
            # each row's steps in two halves (two warps), summed after
            halves = []
            Vu = V[unit * 64:(unit + 1) * 64]
            for k1 in (0, S // 4):
                d = [torch.zeros((8, 8, 4, 4), dtype=torch.float64)
                     for _ in range(MT)]
                for ks in range(k1, k1 + S // 4):
                    half, h = LT >> 1, LT & 1
                    u = pl[:, 2 * ks + half].expand(8, 8, 4)  # (row, g, t)
                    b = _b_regs(Vu, S, ks)
                    if W == 32:
                        g = LG.expand(8, 4)
                        q0 = panel[u, 2 * (2 * g + half) + h]
                        q1 = panel[u, 2 * (2 * g + (half ^ 1)) + h]
                        sel = (half == 1)[..., None, None]
                        d[0] = _mma(d[0], torch.where(sel, q1, q0), b)
                        d[1] = _mma(d[1], torch.where(sel, q0, q1), b)
                    else:
                        d[0] = _mma(d[0], panel[u, 2 * (LG % 4) + h], b)
                halves.append(d)
            d = [a.float() + b.float() for a, b in zip(*halves)]
            if W == 32:
                col0 = (j0 + 4 * LG).expand(8, 4)[None].expand(8, 8, 4)
                _store(Y, writes, r, col0, d[0], d[1])
            else:
                g4 = torch.arange(4)
                col0 = (j0 + 2 * g4[:, None]).expand(4, 4)[None].expand(
                    8, 4, 4)
                _store(Y, writes, r, col0, d[0][:, :4])
    return Y, writes


def _spmm_layout(case):
    """(V, cols, X rows) of a layout of test_cuda_spmm_probes_match_plain
    (the 5x5x6 brick's K; a random one of 5 tiles, S 20; one of 300 tiles)
    or "distinct": 2 tiles of S 64 whose units' 8 S block columns are all
    distinct (the largest union a unit can have)."""
    rng = np.random.default_rng(7)
    if case == "brick":
        cav = PermutedProblem(BrickCavity3D(nx=5, ny=5, nz=6))
        A = BSRMatrix.from_csr(cav.K, block=8, device="cpu")
        return spp.panel_values(A.blocks), A.cols, A.n_padded + 8
    if case == "distinct":
        nbr, S = 32, 64
        cols = torch.from_numpy(rng.permutation(nbr * S).astype(
            np.int32)).view(nbr, S)
    else:
        nbr, S = (5 if case == "random" else 300) * 16, 20
        cols = torch.from_numpy(rng.integers(0, nbr + 1, (nbr, S)).astype(
            np.int32))
    V = torch.from_numpy(rng.standard_normal((nbr * 8, S * 8)).astype(
        np.float32))
    return V, cols, 8 * (int(cols.max()) + 2)


@pytest.mark.parametrize("case", ["brick", "random", "many", "distinct"])
def test_union_map_is_each_units_sorted_union(case):
    """v2_panel_def's union map, as the kernel builds it from cols
    (bitmap, prefix popcount over its words, the union's columns word by
    word, each slot's place), equals torch.unique of each unit's 8 S block
    columns exactly; every slot's place holds its own column, so the slice
    the panel stages there is X[8 c : 8 c + 8]; the host's largest union is
    the largest of them."""
    V, cols, x_rows = _spmm_layout(case)
    X = torch.arange(x_rows, dtype=torch.float32)[:, None].expand(
        x_rows, 8).contiguous()
    units = cols.reshape(cols.shape[0] // 8, -1).long()
    maps = emulate_union_map(cols, x_rows)
    for unit, (ucol, places) in zip(units, maps):
        assert torch.equal(ucol, torch.unique(unit))
        assert torch.equal(ucol[places], unit)
        panel = X.view(-1, 8, 8)[ucol]
        for c, p in zip(unit.tolist(), places.tolist()):
            assert torch.equal(panel[p], X[8 * c: 8 * c + 8])
    sizes = torch.tensor([u.numel() for u, _ in maps])
    assert torch.equal(spp.union_sizes(cols), sizes)
    largest, fresh = spp.largest_union(cols)
    assert fresh and largest == int(sizes.max())
    assert spp.largest_union(cols) == (largest, False)  # cached
    cols[0, 0] = cols[0, 0]  # a write: reckoned again
    assert spp.largest_union(cols)[1]
    if case == "distinct":
        assert largest == 8 * cols.shape[1]


def test_union_plan_at_the_probe_layout():
    """At the 24^3 probe layout (4,768 block rows, S 64) the largest 8-row
    union is 162 block columns (mean 84.4): at m 8 one pass of 8, from m
    32 passes of 32, each panel within the H100's 232,448 bytes, twice to
    an SM; where a union does not fit at 32 columns the passes are 8 wide,
    and where it does not fit at 8 the width is refused."""
    prob = PermutedProblem(BrickCavity3D(nx=24, ny=24, nz=24))
    A = BSRMatrix.from_csr(prob.K.tocsr(), block=8, device="cpu")
    sizes = spp.union_sizes(A.cols).double()
    largest = spp.largest_union(A.cols)[0]
    assert largest == 162 and abs(sizes.mean().item() - 84.43) < 0.01
    for m in spp.MS:
        plan = spp.union_plan(largest, A.slots, m, A.n_padded)
        W = 8 if m == 8 else 32
        assert plan == {"unit": 8, "pass_width": W, "passes": m // W,
                        "largest_union": 162,
                        "smem": spp.union_smem(W, 162, 64, A.n_padded)}
        assert plan["smem"] == 162 * 16 * W + 8192 + 8 * 149 \
            + 4 * 8 * 64 + 4 * 162 + 16
        assert 2 * (plan["smem"] + 1024) <= 233472 <= 2 * spp.SMEM_LIMIT
    assert spp.union_plan(512, 64, 128, A.n_padded)["pass_width"] == 8
    assert spp.union_plan(416, 52, 128, 8 * 834)["pass_width"] == 32
    with pytest.raises(ValueError, match="shared memory"):
        spp.union_plan(2048, 256, 32, A.n_padded)


@pytest.mark.parametrize("m", [8, 32, 64, 128])
@pytest.mark.parametrize("case", ["brick", "random"])
def test_v5_def_map_emulated_matches_plain(case, m):
    """def_direct_kernel's column and store map in torch: each lane's four
    k rows of a step as a float4 per 32 columns (m 8: column g), tiles 2 i
    and 2 i + 1 packed from .x/.y and .z/.w, the PTX m16n8k16 product, Y
    stored as float4s at column 32 i + 4 g: every Y element written once,
    the product within 1e-5 of max|plain| of product_def_plain."""
    V, cols, x_rows = _spmm_layout(case)
    X = torch.from_numpy(_x(x_rows, m))
    Y, writes = emulate_v5_def(V, cols, X)
    assert torch.equal(writes, torch.ones_like(writes))
    want = spp.product_def_plain(V, cols, X)
    assert (Y - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("case,m,W", [("brick", 8, 8), ("brick", 64, 32),
                                      ("random", 32, 32),
                                      ("random", 128, 32),
                                      ("distinct", 32, 8)])
def test_v2_def_panel_emulated_matches_plain(case, m, W):
    """union_def_kernel's panel and reads in torch: per unit and pass the
    union's slices staged into 16-byte chunks item by item, each lane's
    chunks through its slots' places (W 32 in the swapped order of the
    step's second slot), the PTX product over each half of a row's steps,
    the halves added, the stores (W 8: lanes g < 4):
    every Y element written once, within 1e-5 of max|plain| of
    product_def_plain; the passes the host plans for the layout."""
    V, cols, x_rows = _spmm_layout(case)
    X = torch.from_numpy(_x(x_rows, m))
    plan = spp.union_plan(spp.largest_union(cols)[0], cols.shape[1], m,
                          x_rows)
    assert plan["pass_width"] == W and plan["passes"] == m // W
    Y, writes = emulate_v2_def(V, cols, X, W)
    assert torch.equal(writes, torch.ones_like(writes))
    want = spp.product_def_plain(V, cols, X)
    assert (Y - want).abs().max() <= 1e-5 * want.abs().max()
