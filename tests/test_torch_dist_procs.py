"""The row-sharded pencil on P processes (maxwell_tpu_torch/dist/procs.py,
gloo ranks on the CPU) against the one-process stacked view and against
the JAX package's shard_map solves on its 8-device CPU mesh. D = 8 shards
over P = 2, 4 and 8 ranks (one shard a rank at P = 8).

Bounds:
- halos (both layouts, every transport), the K, M and fused applies (the
  "ref" blocked-ELL apply at f64, the union and "pallas" plain applies at
  f32), the fused interior SpMM + halo section, and the reductions
  (dot_mm, dot_cols, col_norms, dot_vv, dot_basis): bit for bit the one
  process (each shard's partial is the same call, the partials are added
  in shard order);
- the projection: G^T adds each rank's partial over its own edges in
  rank order, another order of a node's edges than one process's sum, so
  within 32 eps of the working dtype of max |x| (measured: under 2 eps);
- the solves, which project every search direction: the eigenvalues
  within 1e-12 (f64) and 1e-5 (f32, the solve's tolerance) relative of
  one process's (measured: 2e-15 and 4e-7 over 4-8 ranks), and the
  converged ones within test_torch_dist_solve.py's bounds of the
  reference's (1e-12 at f64, 2e-5 at f32) from the reference's start
  block. The staged and Krylov runs are short (4 iterations, 10 steps,
  two restarts) and run at P 2 only, the converged LOBPCG at P 2 and 4:
  a gloo collective costs a rank 0.4-9 ms on an 8-core CPU under load, and a
  solve makes thousands.
"""

import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist import partition_problem as ref_partition
from maxwell_tpu.problems import BrickCavity3D as RefBrick
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.solvers.dist_solve import lobpcg_dist as ref_lobpcg_dist
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.dist import make_mesh, procs
from maxwell_tpu_torch.dist import rank_tasks as rt

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
D = 8
# on the CPU "rdma" runs the plain transport; ("pallas", "rdma") takes
# that road, so ("ref", "rdma") would repeat ("ref", "ppermute")
CASES = [("ref", "ppermute", "f64"), ("pallas", "rdma", "f32"),
         ("union", "rdma_overlap", "f32"), ("union", "ppermute", "f32")]
SPECS = {"rect16": ("rect", 16), "brick6": ("brick", 6)}
EPS = {"f32": float(np.finfo(np.float32).eps),
       "f64": float(np.finfo(np.float64).eps)}


def _start(ref, m):
    return np.asarray(ref.make_block(jax.random.PRNGKey(0), m))


@pytest.fixture(scope="module")
def reference():
    """The reference's converged distributed LOBPCG on the deep 6^3 brick
    (f64) and the shallow 16x16 rectangle (f32), with their start blocks."""
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    mesh = ref_make_mesh(D)
    r6 = ref_partition(RefBrick(nx=6, ny=6, nz=6), D, dtype=jnp.float64)
    r16 = ref_partition(RefRect(nx=16, ny=16), D, block=8,
                        dtype=jnp.float32)
    return {
        "brick6": (_start(r6, 7), ref_lobpcg_dist(
            r6, mesh, nev=3, maxiter=60, tol=1e-8, precond_alpha=15.0)),
        "rect16": (_start(r16, 7), ref_lobpcg_dist(
            r16, mesh, nev=3, maxiter=60, tol=1e-5, precond_alpha=10.0)),
    }


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


def _calls(P, reference, tmp_dir):
    """[(key, (task, args))] at P ranks: the apply checks of both problems;
    at P < 8 the converged LOBPCG solves; at P 1 and 2 the staged and
    Krylov runs and config 4 through the CLI's rank path."""
    calls = [(("applies", s), (rt.apply_checks, (SPECS[s], D, P, "cpu",
                                                  CASES)))
             for s in SPECS]
    if P < 8:
        calls += [(("solves", s), (rt.solve_checks,
                                   (SPECS[s], D, P, "cpu", *args)))
                  for s, args in _solves(reference, P <= 2).items()]
    if P <= 2:
        argv = [_config4(tmp_dir), "--device", "cpu", "--procs", str(P)]
        calls.append((("cli", None), (rt.cli, (argv,))))
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
    return _run(_calls(1, reference, tmp_path_factory.mktemp("one")), 1)


@pytest.fixture(scope="module")
def spawned(reference, tmp_path_factory):
    """{P: results} of P gloo ranks for P 2, 4 and 8, one spawn each for
    all its checks."""
    out = {}
    for P in (2, 4, 8):
        t0 = time.perf_counter()
        out[P] = _run(_calls(P, reference, tmp_path_factory.mktemp(f"p{P}")),
                      P)
        out[P]["seconds"] = time.perf_counter() - t0
    return out


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
            if name == "project":
                bound = 32 * EPS[case[2]] * np.abs(w).max()
                assert np.abs(g - w).max() <= bound, (m, name)
            else:
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
