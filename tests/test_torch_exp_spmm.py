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
