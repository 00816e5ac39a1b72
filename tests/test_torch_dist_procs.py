"""The row-sharded pencil on P processes (maxwell_tpu_torch/dist/procs.py,
gloo ranks on the CPU) against the one-process stacked view and against
the JAX package's shard_map solves on its 8-device CPU mesh. D = 8 shards
over P = 2, 4 and 8 ranks (one shard a rank at P = 8).

Bounds:
- halos (both layouts, every transport), the K, M and fused applies (the
  "ref" blocked-ELL apply at f64, the union and "pallas" plain applies at
  f32), the fused interior SpMM + halo section, the reductions (dot_mm,
  dot_cols, col_norms, dot_vv, dot_basis) and the projection: bit for bit
  the one process (each shard's partial is the same call, the partials
  are added in shard order; G^T gathers the ranks' rows and sums each
  node's edges as one process does);
- the solves: the eigenvalues within 1e-12 (f64) and 1e-5 (f32, the
  solve's tolerance) relative of one process's, and the
  converged ones within test_torch_dist_solve.py's bounds of the
  reference's (1e-12 at f64, 2e-5 at f32) from the reference's start
  block. The staged and Krylov runs are short (4 iterations, 10 steps,
  two restarts) and run at P 2 only, the converged LOBPCG at P 2 and 4:
  a gloo collective costs a rank 0.4-9 ms on an 8-core CPU under load, and a
  solve makes thousands;
- shift-invert (shift_invert_lanczos_dist and thick_restart_lanczos_dist(
  mode="shift_invert"), the MINRES apply) at P 2 and 4 in the reference's
  own cases (tests/distributed/test_si_dist.py's 12 x 12 rectangle, sigma
  45, nev 4, 30 steps; test_trlanczos_dist.py's 10 x 10 rectangle, sigma
  between modes 3 and 4, nev 2, ncv 10) from the reference's start vector:
  the eigenvalues within rtol 1e-7 of the reference's and of the dense
  spectrum, and bit for bit one process's, the Lanczos alphas and betas
  too;
- checkpoints on the brick: a LOBPCG run stopped by maxiter at P 2 with
  checkpoint_every 2 leaves the D shard files, bit for bit the ones one
  process writes from the same start, and the exit-time file; resumed
  from the shard files at P 4 (which rewrites the exit-time file alone)
  and in one process the runs start at the saved iteration and are bit
  for bit the same run, their eigenvalues within 1e-12 of the unbroken
  run's; the exit-time file resumes at D 4; config 4 through the CLI
  with --procs 2 --checkpoint, resumed with --procs 4, ends within 1e-10
  of the one-process run.
"""

import json
import shutil
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist import partition_problem as ref_partition
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.solvers.dist_solve import lobpcg_dist as ref_lobpcg_dist
from maxwell_tpu.solvers.dist_solve import (
    shift_invert_lanczos_dist as ref_si_dist,
)
from maxwell_tpu.solvers.trlanczos import (
    thick_restart_lanczos_dist as ref_trl_dist,
)
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.dist import make_mesh, partition_problem, procs
from maxwell_tpu_torch.dist import rank_tasks as rt
from maxwell_tpu_torch.problems import RectCavity2D
from maxwell_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
D = 8
# on the CPU "rdma" runs the plain transport; ("pallas", "rdma") takes
# that road, so ("ref", "rdma") would repeat ("ref", "ppermute")
CASES = [("ref", "ppermute", "f64"), ("pallas", "rdma", "f32"),
         ("union", "rdma_overlap", "f32"), ("union", "ppermute", "f32")]
SPECS = {"rect16": ("rect", 16), "brick6": ("brick", 6)}


# the checkpointed LOBPCG on the brick: stopped by maxiter, then resumed
CKPT_PENCIL = ("rows", ("brick", 6), "ref", "ppermute", "f64")
CKPT_KW = dict(nev=3, m=7, tol=1e-8, precond_alpha=15.0)
CKPT_STOP = 4  # iterations of the stopped run; a snapshot every 2
CKPT_FILES = ["ckpt.npz"] + [f"ckpt.npz.shard{d}" for d in range(D)]


def _start(ref, m):
    return np.asarray(ref.make_block(jax.random.PRNGKey(0), m))


def _positive_spectrum(nx):
    cav = RectCavity2D(nx=nx, ny=nx)
    w = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(), eigvals_only=True)
    return np.sort(w[w > 1e-8])


@pytest.fixture(scope="module")
def reference():
    """The reference's converged distributed LOBPCG on the deep 6^3 brick
    (f64) and the shallow 16x16 rectangle (f32), with their start blocks;
    its shift-invert cases (f64, block 8, RCM) with their start vectors,
    keyword arguments and the dense positive spectrum."""
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    mesh = ref_make_mesh(D)
    r6 = ref_partition(RefBrick(nx=6, ny=6, nz=6), D, dtype=jnp.float64)
    r16 = ref_partition(RefRect(nx=16, ny=16), D, block=8,
                        dtype=jnp.float32)
    out = {
        "brick6": (_start(r6, 7), ref_lobpcg_dist(
            r6, mesh, nev=3, maxiter=60, tol=1e-8, precond_alpha=15.0)),
        "rect16": (_start(r16, 7), ref_lobpcg_dist(
            r16, mesh, nev=3, maxiter=60, tol=1e-5, precond_alpha=10.0)),
    }
    pos = _positive_spectrum(10)
    for name, nx, fn, kw in (
            ("si12", 12, ref_si_dist,
             dict(sigma=45.0, nev=4, maxiter=30, tol=1e-7)),
            ("trl10", 10, ref_trl_dist,
             dict(mode="shift_invert", sigma=float(0.5 * (pos[2] + pos[3])),
                  nev=2, ncv=10, max_restarts=30, tol=1e-8))):
        ref = ref_partition(RefRect(nx=nx, ny=nx), D, block=8,
                            dtype=jnp.float64, reorder=True)
        out[name] = (_start(ref, 1)[:, 0], kw, fn(ref, mesh, **kw),
                     _positive_spectrum(nx))
    return out


def _solves(reference, krylov):
    """{spec: (kernel, halo_impl, dtype, runs)} of the solve checks: the
    converged LOBPCG of each problem from the reference's start block, and
    with `krylov` the staged solve and short Krylov runs on the brick."""
    X6, _ = reference["brick6"]
    X16, _ = reference["rect16"]
    brick = {"lobpcg": ("lobpcg_dist", dict(nev=3, maxiter=60, tol=1e-8,
                                            precond_alpha=15.0, X0=X6))}
    if krylov:
        brick.update({
            "staged": ("lobpcg_dist", dict(nev=2, batch=1, m=4, maxiter=4,
                                           tol=1e-30, precond_alpha=15.0)),
            "lanczos": ("lanczos_dist", dict(nev=2, maxiter=10, tol=1e-30)),
            "trlanczos": ("thick_restart_lanczos_dist",
                          dict(nev=2, ncv=8, max_restarts=2, tol=1e-30))})
    return {
        "brick6": ("ref", "ppermute", "f64", brick),
        "rect16": ("union", "rdma_overlap", "f32", {
            "lobpcg": ("lobpcg_dist", dict(nev=3, maxiter=60, tol=1e-5,
                                           precond_alpha=10.0, X0=X16))}),
    }


def _config4(tmp_dir) -> str:
    """Config 4 as written (f64, 8 shards, "auto" -> "ref" on the CPU),
    shrunk to the 6^3 brick and 3 pairs."""
    cfg = json.loads((CONFIGS / "config4.json").read_text())
    cfg["problem"].update(nx=6, ny=6, nz=6)
    cfg["solver"].update(nev=3, maxiter=60)
    path = tmp_dir / "config4_small.json"
    path.write_text(json.dumps(cfg))
    return str(path)


SI = {"si12": ("shift_invert_lanczos_dist", ("rect", 12)),
      "trl10": ("thick_restart_lanczos_dist", ("rect", 10))}


def _si_calls(P, reference):
    """The shift-invert cases on P ranks from the reference's start
    vectors ("ref" apply, f64, block 8 as the reference's layout)."""
    return [(("si", name), (rt.solve_checks, (
        spec, D, P, "cpu", "ref", "ppermute", "f64",
        {"run": (solver, {**reference[name][1], "v0": reference[name][0]})},
        (), 8))) for name, (solver, spec) in SI.items()]


def _ckpt_write(P, reference, ckpt_dir, config4):
    """The stopped checkpointed LOBPCG from the reference's start block and
    config 4 through the CLI's rank path, --maxiter cut, into ckpt_dir."""
    kw = {**CKPT_KW, "maxiter": CKPT_STOP, "checkpoint_every": 2,
          "X0": reference["brick6"][0]}
    argv = [config4, "--device", "cpu", "--procs", str(P), "--maxiter",
            str(CKPT_STOP), "--checkpoint", str(ckpt_dir / "cli.npz"),
            "--checkpoint-every", "2"]
    return [(("ckpt", "write"), (rt.checkpoint_run, (
        CKPT_PENCIL, D, P, "cpu", str(ckpt_dir / "ckpt.npz"), kw))),
            (("ckpt", "cli_write"), (rt.cli, (argv,)))]


def _ckpt_resume(P, ckpt_dir, config4):
    """The resumes from ckpt_dir's shard files (its exit-time files
    removed): the LOBPCG and config 4 through the CLI's rank path."""
    argv = [config4, "--device", "cpu", "--procs", str(P), "--checkpoint",
            str(ckpt_dir / "cli.npz")]
    return [(("ckpt", "resume"), (rt.checkpoint_run, (
        CKPT_PENCIL, D, P, "cpu", str(ckpt_dir / "ckpt.npz"),
        {**CKPT_KW, "maxiter": 60}))),
            (("ckpt", "cli_resume"), (rt.cli, (argv,)))]


def _shard_copy(src, dst, keep_exit=False):
    """A copy of the checkpoint directory src at dst, its exit-time files
    removed (unless keep_exit): a resume then takes the shard files."""
    shutil.copytree(src, dst)
    if not keep_exit:
        for name in ("ckpt.npz", "cli.npz"):
            (dst / name).unlink()
    return dst


def _files(ckpt_dir):
    """The names of the files of the checkpoint ckpt.npz in ckpt_dir."""
    return sorted(p.name for p in ckpt_dir.glob("ckpt.npz*"))


def _calls(P, reference, tmp_dir, ckpt_dir=None):
    """[(key, (task, args))] at P ranks: the apply checks of both problems;
    at P < 8 the converged LOBPCG solves and the shift-invert cases; at P 1
    and 2 the staged and Krylov runs, config 4 through the CLI's rank path
    and the stopped checkpointed runs into ckpt_dir; at P 4 the resumes
    from ckpt_dir."""
    calls = [(("applies", s), (rt.apply_checks, (SPECS[s], D, P, "cpu",
                                                  CASES)))
             for s in SPECS]
    if P < 8:
        calls += [(("solves", s), (rt.solve_checks,
                                   (SPECS[s], D, P, "cpu", *args)))
                  for s, args in _solves(reference, P <= 2).items()]
        calls += _si_calls(P, reference)
    config4 = _config4(tmp_dir)
    if P <= 2:
        argv = [config4, "--device", "cpu", "--procs", str(P)]
        calls.append((("cli", None), (rt.cli, (argv,))))
        calls += _ckpt_write(P, reference, ckpt_dir, config4)
    if P == 4:
        calls += _ckpt_resume(P, ckpt_dir, config4)
    return calls


def _run(calls, P):
    """The calls on P gloo ranks (in this process for P 1), their results
    filed by key."""
    tasks = [c for _, c in calls]
    results = (rt.sequence(tasks) if P == 1
               else procs.spawn(rt.sequence, P, tasks, device="cpu"))
    out = {}
    for ((kind, key), _), r in zip(calls, results):
        out.setdefault(kind, {})[key] = r
    return out


@pytest.fixture(scope="module")
def one(reference, tmp_path_factory):
    """The one-process stacked view, in this process."""
    tmp = tmp_path_factory.mktemp("one")
    out = _run(_calls(1, reference, tmp, tmp / "ckpt"), 1)
    out["ckpt_dir"] = tmp / "ckpt"
    return out


@pytest.fixture(scope="module")
def spawned(reference, tmp_path_factory):
    """{P: results} of P gloo ranks for P 2, 4 and 8, one spawn each for
    all its checks; P 4 resumes from a copy of P 2's checkpoints."""
    out = {}
    for P in (2, 4, 8):
        tmp = tmp_path_factory.mktemp(f"p{P}")
        ckpt = tmp / "ckpt"
        if P == 4:
            _shard_copy(out[2]["ckpt_dir"], ckpt)
        t0 = time.perf_counter()
        out[P] = _run(_calls(P, reference, tmp, ckpt), P)
        out[P]["seconds"] = time.perf_counter() - t0
        out[P]["ckpt_dir"] = ckpt
    return out


@pytest.fixture(scope="module")
def resumed(spawned, tmp_path_factory):
    """In this process, from copies of P 2's checkpoints: the resume from
    the shard files at D 8, and from the exit-time file at D 4."""
    tmp = tmp_path_factory.mktemp("resumed")
    src = spawned[2]["ckpt_dir"]
    shards = _shard_copy(src, tmp / "shards")
    exit_file = _shard_copy(src, tmp / "exit", keep_exit=True)
    kw = {**CKPT_KW, "maxiter": 60}
    return {"shards": rt.checkpoint_run(CKPT_PENCIL, D, 1, "cpu",
                                        str(shards / "ckpt.npz"), kw),
            "exit_d4": rt.checkpoint_run(CKPT_PENCIL, 4, 1, "cpu",
                                         str(exit_file / "ckpt.npz"), kw)}


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("P", [2, 4, 8])
def test_applies_and_reductions_match_one_process(spawned, one, P, spec,
                                                  case):
    got, want = spawned[P]["applies"][spec][case], one["applies"][spec][case]
    assert set(got) == set(want)
    for m in want:
        assert set(got[m]) == set(want[m])
        for name, w in want[m].items():
            g = got[m][name]
            assert g.shape == w.shape and g.dtype == w.dtype, (m, name)
            assert np.array_equal(g, w), (m, name)


# (P, problem, run): the converged LOBPCG at P 2 and 4, the staged and
# Krylov runs at P 2
SOLVES = [(P, spec, "lobpcg") for P in (2, 4) for spec in SPECS] + [
    (2, "brick6", label) for label in ("staged", "lanczos", "trlanczos")]


@pytest.mark.parametrize("P,spec,label", SOLVES,
                         ids=[f"{P}-{s}-{lab}" for P, s, lab in SOLVES])
def test_solves_match_one_process(spawned, one, P, spec, label):
    got, want = spawned[P]["solves"][spec][label], one["solves"][spec][label]
    dtype = {"brick6": "f64", "rect16": "f32"}[spec]
    rtol = {"f64": 1e-12, "f32": 1e-5}[dtype]
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=rtol)
    assert got["eigenvectors"].shape == want["eigenvectors"].shape
    assert np.all(np.isfinite(got["eigenvectors"]))
    assert got["converged"] == want["converged"]
    # every rank ran the same plain kernels, as many times
    counts = got["counts"]
    assert len(counts) == P
    assert all(c == counts[0] for c in counts)


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("P", [2, 4])
def test_lobpcg_matches_reference(spawned, reference, P, spec):
    got = spawned[P]["solves"][spec]["lobpcg"]
    want = reference[spec][1]
    tol, rtol = {"brick6": (1e-8, 1e-12), "rect16": (1e-5, 2e-5)}[spec]
    assert got["converged"] and got["residuals"].max() <= tol
    np.testing.assert_allclose(got["eigenvalues"], want.eigenvalues,
                               rtol=rtol)


def test_cli_config4_on_two_processes(spawned, one):
    """Config 4 (shrunk) through the CLI's rank path with --procs 2: rank
    0's history and report against the one-process run's."""
    (hist, rep), (hist1, rep1) = spawned[2]["cli"][None], one["cli"][None]
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert len(hist) == rep["iterations"] == rep1["iterations"]
    np.testing.assert_allclose(rep["eigenvalues"], rep1["eigenvalues"],
                               rtol=1e-12)
    assert rep["n"] == rep1["n"]


def _nearest(vals, sigma, k):
    return np.sort(vals[np.argsort(np.abs(vals - sigma))[:k]])


@pytest.mark.parametrize("name", list(SI))
@pytest.mark.parametrize("P", [2, 4])
def test_shift_invert_matches_reference(spawned, reference, P, name):
    """The reference's own shift-invert cases on P processes: converged,
    the eigenvalues within 1e-7 of its and of the dense spectrum's nearest
    to sigma; eigenvectors in the problem's order."""
    got = spawned[P]["si"][name]["run"]
    _, kw, want, spectrum = reference[name]
    assert got["converged"], got["residuals"]
    np.testing.assert_allclose(np.sort(got["eigenvalues"]),
                               np.sort(want.eigenvalues), rtol=1e-7)
    np.testing.assert_allclose(np.sort(got["eigenvalues"]),
                               _nearest(spectrum, kw["sigma"], kw["nev"]),
                               rtol=1e-7)
    nx = SI[name][1][1]
    assert got["eigenvectors"].shape == (RectCavity2D(nx=nx, ny=nx).n_edges,
                                         kw["nev"])


@pytest.mark.parametrize("name", list(SI))
@pytest.mark.parametrize("P", [2, 4])
def test_shift_invert_matches_one_process(spawned, one, P, name):
    """P processes against one at f64: the eigenvalues, residuals and the
    Lanczos tridiagonal bit for bit; every rank made the same gathers and
    called the same plain kernels as often."""
    got, want = spawned[P]["si"][name]["run"], one["si"][name]["run"]
    assert np.array_equal(got["eigenvalues"], want["eigenvalues"])
    assert np.array_equal(got["residuals"], want["residuals"])
    assert got["iterations"] == want["iterations"]
    if want["tridiagonal"] is not None:
        for g, w in zip(got["tridiagonal"], want["tridiagonal"]):
            assert np.array_equal(g, w)
    assert len(got["gathers"]) == P and len(set(got["gathers"])) == 1
    assert got["gathers"][0] > 0 and want["gathers"] == [0]
    assert all(c == got["counts"][0] for c in got["counts"])


def test_checkpoint_shards_match_one_process(spawned, one):
    """The stopped run at P 2 leaves the D shard files one process writes
    from the same start, bit for bit (X, theta, iteration), and the
    exit-time file: those files and no other."""
    got, want = spawned[2]["ckpt"]["write"], one["ckpt"]["write"]
    assert got["iterations"] == want["iterations"] == CKPT_STOP
    for name in CKPT_FILES:
        a = load_state(str(spawned[2]["ckpt_dir"] / name))
        b = load_state(str(one["ckpt_dir"] / name))
        assert a["iteration"] == b["iteration"] == CKPT_STOP, name
        assert np.array_equal(a["X"], b["X"]), name
        assert np.array_equal(a["theta"], b["theta"]), name
    for run in (spawned[2], one):
        assert _files(run["ckpt_dir"]) == sorted(CKPT_FILES)


def test_checkpoint_resumes_at_another_process_count(spawned, one,
                                                     resumed):
    """From P 2's shard files (the exit-time file removed), at P 4 and in
    one process: both start at the saved iteration and are the same run
    bit for bit (history, eigenvalues, eigenvectors), converged within
    1e-12 of the unbroken one-process run's eigenvalues."""
    p4, p1 = spawned[4]["ckpt"]["resume"], resumed["shards"]
    unbroken = one["solves"]["brick6"]["lobpcg"]
    for r in (p4, p1):
        assert r["history"][0][0] == CKPT_STOP
        assert r["converged"] and r["residuals"].max() <= 1e-8
        np.testing.assert_allclose(r["eigenvalues"],
                                   unbroken["eigenvalues"], rtol=1e-12)
    assert p4["history"] == p1["history"]
    for key in ("eigenvalues", "residuals", "eigenvectors"):
        assert np.array_equal(p4[key], p1[key]), key
    # the resume wrote the exit-time file (removed before it) and left the
    # shard files as P 2 wrote them
    assert _files(spawned[4]["ckpt_dir"]) == sorted(CKPT_FILES)
    for name in CKPT_FILES[1:]:
        assert ((spawned[4]["ckpt_dir"] / name).stat().st_mtime_ns
                == (spawned[2]["ckpt_dir"] / name).stat().st_mtime_ns), name


def test_exit_time_checkpoint_resumes_at_another_shard_count(resumed, one):
    """P 2's exit-time file (the problem's ordering) resumes at D 4 in one
    process, from the saved iteration."""
    r = resumed["exit_d4"]
    assert r["history"][0][0] == CKPT_STOP
    assert r["converged"] and r["residuals"].max() <= 1e-8
    np.testing.assert_allclose(
        r["eigenvalues"], one["solves"]["brick6"]["lobpcg"]["eigenvalues"],
        rtol=1e-12)


def test_cli_checkpoint_resumes_with_more_processes(spawned, one):
    """Config 4 through the CLI with --procs 2 --checkpoint, stopped by
    --maxiter, then resumed with --procs 4 from its shard files: rank 0's
    history starts at the saved iteration and the eigenvalues end within
    1e-10 of the unbroken one-process run's."""
    hist2, rep2 = spawned[2]["ckpt"]["cli_write"]
    hist4, rep4 = spawned[4]["ckpt"]["cli_resume"]
    assert rep2["iterations"] == len(hist2) == CKPT_STOP
    assert not rep2["converged"]
    assert all((spawned[2]["ckpt_dir"] / f"cli.npz.shard{d}").exists()
               for d in range(D))
    assert hist4[0]["iter"] == CKPT_STOP
    assert rep4["iterations"] == CKPT_STOP + len(hist4)
    assert rep4["converged"] and max(rep4["residuals"]) <= 1e-8
    np.testing.assert_allclose(rep4["eigenvalues"],
                               one["cli"][None][1]["eigenvalues"],
                               rtol=1e-10)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_k5_on_ranks_of_padding_rows_matches_one_process(spawned, one, P):
    """F5: on the 16x16 rectangle in 8 union shards, shards 4-7 hold only
    padding rows, so rank 1 of 2, ranks 2-3 of 4 and 4-7 of 8 hold no
    live row. On such a rank K5's plain path writes both streams' products
    (zero there) and the halo section, bit for bit the one process's rows."""
    case = ("union", "rdma_overlap", "f32")
    dp = partition_problem(RectCavity2D(nx=16, ny=16), D, kernel="union",
                           dtype=torch.float32, device="cpu")
    rows = (D // P) * dp.Lb
    padding = [r for r in range(P) if r * rows >= dp.n]
    assert padding == list(range(P // 2, P))
    for m, want in one["applies"]["rect16"][case].items():
        got = spawned[P]["applies"]["rect16"][case][m]
        assert "overlap" in got and "overlap" in want
        for r in padding:
            mine = slice(r * rows, (r + 1) * rows)
            for s in range(2):  # both streams
                Y = got["overlap"][s][mine]
                assert np.array_equal(Y, want["overlap"][s][mine])
                assert not Y.any()
            halo = slice(r * 2 * dp.Hb * (D // P),
                         (r + 1) * 2 * dp.Hb * (D // P))
            assert np.array_equal(got["overlap_halo"][halo],
                                  want["overlap_halo"][halo])


def test_uneven_shards_raise():
    with pytest.raises(ValueError, match="divide"):
        make_mesh(D, "cpu", 3)
    with pytest.raises(ValueError, match="inside a rank"):
        make_mesh(D, "cpu", 2)  # no spawn around it


def test_a_rank_that_raises_ends_the_run():
    t0 = time.perf_counter()
    with pytest.raises(procs.RankError, match="rank 1 of 2") as err:
        procs.spawn(rt.raise_on, 2, 1, "the drill's error", device="cpu")
    assert "ValueError: the drill's error" in str(err.value)
    assert time.perf_counter() - t0 < 120  # the other ranks did not hang


def test_cli_refuses_procs_off_the_assembled_road():
    # the slab road (config4_stencil) runs on P processes since the slab
    # pencil took a mesh; the one-device solvers still refuse --procs
    for name in ("config7_dielectric.json", "config2.json"):
        with pytest.raises(ValueError, match="--procs"):
            port_cli.main([str(CONFIGS / name), "--device", "cpu",
                           "--procs", "2"])
