"""The tile-union probes of maxwell_tpu_torch (kernels/union_probes.py,
bench/exp_union.py, bench/exp_union2.py) against the JAX package's probes
on the CPU, where the wrappers run their plain versions.

The reference's probe kernels (maxwell_tpu/bench/exp_union.py,
exp_union2.py) are closures inside main() with no interpret switch, so
K15a is held to each kernel body's arithmetic restated in jnp, and K15b to
the production union kernel the probe's "cat" variant reproduces
(bellunion_matmat_pallas in interpret mode) on the reference's own layout.
The CUDA kernels themselves are tested in test_torch_cuda.py."""

import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.kernels import spmm as ref_spmm
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.sparse.bellunion import BELLUnion as RefUnion
from maxwell_tpu.sparse.reorder import PermutedProblem as RefPermuted
from maxwell_tpu_torch.bench import exp_union, exp_union2
from maxwell_tpu_torch.kernels import union_probes as up
from maxwell_tpu_torch.sparse.bellunion import BELLUnion

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
T, UC = 10, 16  # T > 8: the (8, UC) SMEM block's row rule is exercised
HI = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module")
def data():
    return exp_union.make_inputs(T, UC)


def _body(idx, vals, X, run, streams=1, dtype=jnp.float32):
    """The probe's kernel body per grid step i, restated in jnp: the (8, n)
    SMEM block of idx at i // 8 read at row i % 8 (exp_union.py:95, :80),
    the run slices of X concatenated (:81-84, :110-114), one dot per value
    stream at HIGHEST (:85-88, :145-150), the streams summed (:171), then
    the rows from 128 T on padded with zeros (:104)."""
    vals = [jnp.asarray(v, dtype) for v in vals[:streams]]
    X = jnp.asarray(X, dtype)
    out = []
    for i in range(T):
        blk = idx[(i // 8) * 8: (i // 8) * 8 + 8]
        r8 = i % 8
        xg = jnp.concatenate([X[int(blk[r8, q]) * 8: int(blk[r8, q]) * 8 + run]
                              for q in range(idx.shape[1])], axis=0)
        y = 0
        for v in vals:
            y = y + jnp.dot(v[128 * i: 128 * (i + 1)], xg,
                            preferred_element_type=dtype, precision=HI)
        out.append(y)
    y = jnp.concatenate(out)
    return np.asarray(jnp.pad(y, ((0, X.shape[0] - 128 * T), (0, 0))))


def _bf16(a):
    """a rounded to bf16 (nearest even), as f64."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
                      np.float64)


CASES = {  # name: (call, index key, run, value streams)
    "u0_hi": (lambda d: up.u0_hi(d["cols"], d["vals"], d["X"]), "cols", 8,
              1),
    "u1_runs": (lambda d: up.u1_runs(d["rcols"], d["vals"], d["X"]),
                "rcols", 64, 1),
    "u2_km": (lambda d: up.u2_km(d["rcols"], d["vals"], d["vals_b"],
                                 d["X"]), "rcols", 64, 2),
}


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items() if k != "n"}


@pytest.mark.parametrize("name", list(CASES))
def test_panel_plain_matches_probe_body(data, name):
    """u0_hi, u1_runs and u2_km (f32) against the probe body at HIGHEST,
    1e-6 of max|ref| (f32 against f32, sums in another order)."""
    call, key, run, streams = CASES[name]
    up.reset_counts()
    got = call(_torch(data)).numpy()
    want = _body(data[key], [data["vals"], data["vals_b"]], data["X"], run,
                 streams)
    assert got.shape == want.shape == data["X"].shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert not got[128 * T:].any()
    c = up.counts()
    assert c[f"{name}_ref"] == 1 and c[name] == 0


def test_u0_def_rounds_operands_to_bf16(data):
    """u0_def (DEFAULT: bf16 operands, f32 sums) against the probe body
    in f64 on bf16-rounded operands (1e-5 of max|ref|), and within 2e-2 of
    u0_hi but not equal to it: it does round."""
    t = _torch(data)
    got = up.u0_def(t["cols"], t["vals"], t["X"]).numpy()
    want = _body(data["cols"], [_bf16(data["vals"])], _bf16(data["X"]), 8,
                 dtype=jnp.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    hi = up.u0_hi(t["cols"], t["vals"], t["X"]).numpy()
    diff = np.abs(got - hi).max() / np.abs(hi).max()
    assert 1e-4 < diff <= 2e-2


@pytest.mark.parametrize("name", [*exp_union.VARIANTS, "u0_def_bf16"])
def test_library_call_matches_plain(data, name):
    """Each variant's library call (the one PyTorch call the probe times
    beside its kernel) computes the plain version's function within its
    stated bound: the f32 bmm calls 1e-5 of max|plain|; u0_def's call on
    the f32 operands (TF32 allowed for that call only, the setting restored
    after) and its second call on operands rounded to bf16 beforehand
    (`u0_def_bf16`, a bf16 output) 1e-2 against the plain product of
    bf16-rounded operands."""
    t = _torch(data)
    prev = torch.backends.cuda.matmul.allow_tf32
    if name == "u0_def_bf16":
        what, call, as_plain, tol = exp_union.library_bf16(t, T, 8 * UC)
        name = "u0_def"
        assert "bf16" in what
    else:
        what, call, as_plain, tol = exp_union.library(name, t, T, 8 * UC)
    key, run, streams, bf16 = exp_union.VARIANTS[name]
    want = up.panel_plain(t[key], t["vals"], t["X"], run, bf16=bf16,
                          vals_b=t["vals_b"] if streams == 2 else None)
    got = as_plain(call())
    assert what and got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max() <= tol * want.abs().max()
    assert tol == (exp_union.LIB_TOL_BF16 if bf16 else exp_union.TOL)
    assert not got[128 * T:].any()
    assert torch.backends.cuda.matmul.allow_tf32 == prev


def test_inputs_are_the_reference_draws():
    """make_inputs draws the reference's arrays in its order
    (exp_union.py:40-48)."""
    d = exp_union.make_inputs(T, UC)
    rng = np.random.default_rng(0)
    nbr = T * 16
    np.testing.assert_array_equal(
        d["cols"], rng.integers(0, nbr, size=(T, UC), dtype=np.int32))
    np.testing.assert_array_equal(
        d["rcols"], rng.integers(0, nbr - 8, size=(T, UC // 8),
                                 dtype=np.int32))
    np.testing.assert_array_equal(
        d["X"], np.asarray(jnp.asarray(rng.standard_normal((nbr * 8 + 64, 8)),
                                       jnp.float32)))
    assert d["vals"].shape == d["vals_b"].shape == (128 * T, 8 * UC)


@pytest.fixture(scope="module")
def rcm_K():
    return RefPermuted(RefBrick(nx=6, ny=5, nz=4)).K.tocsr()


@pytest.mark.parametrize("name", list(exp_union2.VARIANTS))
def test_union_unstaged_plain_matches_pallas_interpret(rcm_K, name):
    """Each variant's (chunk_lanes, pack): the port's plain union_unstaged
    on its own layout against the reference's union kernel in interpret
    mode on BELLUnion.from_csr with the same parameters, and against scipy
    (1e-5 of max|ref|); the own-roofline bytes are exp_union2.py:130's on
    the reference layout."""
    cl, pack = exp_union2.VARIANTS[name]
    ref = RefUnion.from_csr(rcm_K, block=8, dtype=jnp.float32,
                            chunk_lanes=cl, pack=pack)
    port = BELLUnion.from_csr(rcm_K, chunk_lanes=cl, pack=pack, device="cpu")
    assert (port.cl, port.pack, port.n_chunks) == (cl, pack, ref.n_chunks)
    X = np.random.default_rng(cl + pack).standard_normal(
        (port.n_cols_padded, 8)).astype(np.float32)
    up.reset_counts()
    got = up.union_unstaged(port, torch.from_numpy(X)).numpy()
    assert up.counts()["union_unstaged_ref"] == 1
    want = np.asarray(ref_spmm.bellunion_matmat_pallas(
        ref, jnp.asarray(X), interpret=True))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    n = rcm_K.shape[0]
    sc = rcm_K @ X[:n].astype(np.float64)
    assert np.abs(got[:n] - sc).max() <= 1e-5 * np.abs(sc).max()
    m = 8
    assert exp_union2.own_bytes(port, m) == (
        ref.nnz_dense * 4 + ref.ucols.size * 4 + 2 * ref.n_padded * m * 4)


def _digest(name):
    path = os.path.join(ROOT, name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_probes_on_cpu_write_only_out(tmp_path, monkeypatch):
    """Both probe scripts run their plain versions with --device cpu (no
    times: a CPU has no device time), write their JSON to --out, and leave the
    reference's result files at the repo root as they were, even when run
    from the root."""
    roots = ("exp_union_results.json", "exp_union2_results.json")
    before = {r: _digest(r) for r in roots}
    monkeypatch.chdir(ROOT)
    out1, out2 = tmp_path / "u1.json", tmp_path / "u2.json"
    assert exp_union.main(["10", "16", "--device", "cpu", "--out",
                           str(out1)]) == 0
    assert exp_union2.main(["--device", "cpu", "--grid", "6", "--out",
                            str(out2)]) == 0
    assert {r: _digest(r) for r in roots} == before
    r1, r2 = json.loads(out1.read_text()), json.loads(out2.read_text())
    assert r1["device"] == r2["device"] == "cpu"
    for name in ("u0_hi", "u0_def", "u1_runs", "u2_km"):
        assert r1[name]["rel_err"] == 0.0 and "time_s" not in r1[name]
        assert r1[name]["library"] and "launch" not in r1[name]
    assert r1["u0_def"]["library_bf16"]
    assert "f32" in r1["u0_def"]["library"]
    assert list(r2["variants"]) == list(exp_union2.VARIANTS)
    for name, v in r2["variants"].items():
        assert (v["chunk_lanes"], v["pack"]) == exp_union2.VARIANTS[name]
        kinds = {"staged"} if name.startswith("prod") else {"staged",
                                                            "unstaged"}
        for m in (8, 9):
            assert set(v[f"m{m}"]) == kinds
            assert all(v[f"m{m}"][k]["err"] <= 1e-5 for k in kinds)


@pytest.mark.parametrize("probe", ["exp_union", "exp_union2"])
def test_probes_default_to_the_card(monkeypatch, tmp_path, probe):
    """Without --device the probe scripts run on the card; with none
    visible they raise (no fall-back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"exp_union": exp_union, "exp_union2": exp_union2}[probe]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["f64_x", "wide_x", "short_x", "vals_shape",
                                 "k_not_16", "k_past_smem", "idx_int64",
                                 "non_contiguous"])
def test_panel_wrappers_reject_bad_device_input(bad):
    """A tensor that is not on the CPU takes the kernel path, which checks
    its input before any build or launch (meta tensors stand in for CUDA
    ones); nothing falls back to the plain version."""
    Tm, UCm = 3, 16
    K = 8 * UCm
    idx = _meta((Tm, UCm), torch.int32)
    ridx = _meta((Tm, UCm // 8), torch.int32)
    vals = _meta((128 * Tm, K))
    X = _meta((128 * Tm + 64, 8))
    if bad == "f64_x":
        X = _meta((128 * Tm + 64, 8), torch.float64)
    elif bad == "wide_x":
        X = _meta((128 * Tm + 64, 9))
    elif bad == "short_x":
        X = _meta((128 * Tm - 8, 8))
    elif bad == "vals_shape":
        vals = _meta((128 * Tm, K + 16))
    elif bad == "k_not_16":
        idx, ridx = _meta((Tm, 1), torch.int32), _meta((Tm, 1), torch.int32)
        vals = _meta((128 * Tm, 8))
    elif bad == "k_past_smem":  # two panels leave a block's shared memory
        UCb = (up.MAX_K[True] + 16) // 8
        idx = _meta((Tm, UCb), torch.int32)
        ridx = _meta((Tm, UCb // 8), torch.int32)
        vals = _meta((128 * Tm, 8 * UCb))
    elif bad == "idx_int64":
        idx, ridx = idx.long(), ridx.long()
    else:
        X = _meta((8, 128 * Tm + 64)).T
    up.reset_counts()
    for call in (lambda: up.u0_hi(idx, vals, X),
                 lambda: up.u0_def(idx, vals, X),
                 lambda: up.u1_runs(ridx, vals, X),
                 lambda: up.u2_km(ridx, vals, vals, X)):
        with pytest.raises(ValueError):
            call()
    assert not any(up.counts().values())


@pytest.mark.parametrize("bad", ["f64", "non_contiguous", "no_live"])
def test_unstaged_wrapper_rejects_bad_device_input(rcm_K, bad):
    """The kernel path (meta tensors stand in for CUDA ones) raises
    ValueError before any launch: f64 or non-contiguous X, or a layout
    without the live form the kernel reads (K2's refusal)."""
    A = BELLUnion.from_csr(rcm_K, device="cpu")
    X = _meta((A.n_padded, 8))
    if bad == "f64":
        X = _meta((A.n_padded, 8), torch.float64)
    elif bad == "non_contiguous":
        X = _meta((8, A.n_padded)).T
    else:
        A = dataclasses.replace(A, live=None)
    up.reset_counts()
    with pytest.raises(ValueError):
        up.union_unstaged(A, X)
    assert not any(up.counts().values())


def test_counts_reset():
    t = _torch(exp_union.make_inputs(2, 8))
    up.reset_counts()
    up.u0_hi(t["cols"], t["vals"], t["X"])
    up.u2_km(t["rcols"], t["vals"], t["vals_b"], t["X"])
    c = up.counts()
    assert c["u0_hi_ref"] == 1 and c["u2_km_ref"] == 1
    assert sum(c.values()) == 2
    up.reset_counts()
    assert not any(up.counts().values())
