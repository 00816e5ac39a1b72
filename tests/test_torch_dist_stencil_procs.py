"""The slab-sharded matrix-free pencil on P processes
(maxwell_tpu_torch/dist/stencil_dist.py on a mesh over gloo ranks on the
CPU, dist/procs.py) against the one-process stacked view and against the
JAX package's DistStencilPencil3D and DistSpectralShift on its 8-device
CPU mesh. D = 8 slabs of the reference's oracle brick (16 x 5 x 4 cells,
a 1.0 x 1.1 x 0.9 box) over P = 2 and 4 ranks; vacuum at f64 and f32, and
loaded (random eps_r, mu_r) at f64.

Bounds:
- against one process, bit for bit: the ghost-extended blocks, the K, M
  and fused applies (the plain slab apply, and the element apply of the
  loaded pencil), the double-word apply (both words of both operators),
  the projection by CG on the loaded pencil, and the reductions (dot_mm,
  dot_cols, dot_vv, col_norms): each is the same per-slab operations in
  the same order whatever P is;
- against one process, within 1e-13 (f64) and 1e-5 (f32) of max|one
  process|: the vacuum projection (the exact fast nodal solve),
  DistSpectralShift.solve and solve_sigma, and dot_basis. Their y/z
  transforms are one product batched over a process's slabs, whose shape
  holds the slab count and so picks its blocking, and one process's
  dot_basis is one product over the stacked rows, so these round in
  another order (measured: at most 4.3e-16 of max at f64, 5.7e-7 at f32);
- against the reference, the bounds of test_torch_dist_stencil.py and
  test_torch_dist_spectral.py: applies at f64 1e-12, at f32 1e-5 of
  max|ref|; the projection 1e-10 (vacuum) and 1e-8 of max|ref| (loaded:
  both stop their nodal CG at 1e-10); the spectral solves 1e-10;
  dot_mm and dot_cols 1e-12 relative;
- the solve (f32 lobpcg_dist to 1e-5 with the spectral preconditioner,
  then refine_dw_dist to 1e-8, P 2): its eigenvalues within 1e-5 (the
  solve's tolerance) of one process's, the refined ones within 1e-12 and
  within 1e-11 of the reference's refinement of the same block, as
  test_torch_refine_dw_dist.py holds it;
- configs 4_stencil and 5 through the CLI with --procs 2 on copies cut to
  the 8^3 brick in 4 slabs (f64): the same iteration count and history as
  one process's within 1e-9 relative, the eigenvalues within 1e-12;
- shift-invert on the slabs at P 2 and 4: the reference's case (tests/
  distributed/test_si_dist.py, the 8 x 5 x 5 brick in 8 slabs, sigma 60,
  nev 3, 45 steps, from its start vector) within rtol 1e-7 of the
  reference's eigenvalues and of the dense spectrum, and within 1e-9 of
  one process's (its transforms and dot_basis round in another order:
  measured 2.6e-16 relative); thick_restart_lanczos_dist(mode=
  "shift_invert") on the same slabs (nev 1, ncv 8, two cycles, MINRES to
  1e-8) within 1e-9 of one process's (measured 1.5e-15);
- checkpoints on the oracle brick's slabs: the stopped run at P 2 leaves
  the D shard files one process writes from the same start, each column
  within 1e-12 of max|X| up to its sign (the projector's fast nodal solve
  rounds in another order, and eigh picks the signs), and the exit-time
  file; resumed at
  P 4 and in one process from the shard files, both start at the saved
  iteration, take as many iterations and end within 1e-12 of each
  other's eigenvalues; config 4_stencil (cut) through the CLI with
  --procs 2 --checkpoint, resumed with --procs 4, within 1e-10 of one
  process's.

A gloo collective costs a rank 0.4-9 ms on an 8-core CPU under load, so
the solves are short; each process count runs all its checks in one
spawn.
"""

import hashlib
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from jax.sharding import PartitionSpec as PS

from maxwell_tpu.bench.comm_model import CommModel as RefCommModel
from maxwell_tpu.dist import make_mesh as ref_make_mesh
from maxwell_tpu.dist.stencil_dist import (
    DistStencilPencil3D as RefDistStencil,
)
from maxwell_tpu.solvers.dist_solve import lobpcg_dist as ref_lobpcg_dist
from maxwell_tpu.solvers.dist_solve import (
    shift_invert_lanczos_dist as ref_si_dist,
)
from maxwell_tpu.solvers.refine_device import (
    refine_dw_dist as ref_refine_dw_dist,
)
from maxwell_tpu.solvers.spectral import DistSpectralShift as RefShift
from maxwell_tpu_torch.bench import scaling
from maxwell_tpu_torch.bench.comm_model import CommModel
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.dist import procs
from maxwell_tpu_torch.dist import rank_tasks as rt
from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
from maxwell_tpu_torch.problems import BrickCavity3D
from maxwell_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
D = 8
DIMS = dict(a=1.0, b=1.1, c_len=0.9, nx=16, ny=5, nz=4)
_rng = np.random.default_rng(5)
MATERIALS = (1.0 + _rng.random((16, 5, 4)), 1.0 + _rng.random((16, 5, 4)))
CASES = [("f64", None), ("f32", None), ("f64", MATERIALS)]
CASE_IDS = ["f64", "f32", "f64-materials"]
WIDTHS = (1, 3)
SEED = 0
ALPHA = 6.0  # slab_checks' spectral shift
JNP = {"f64": jnp.float64, "f32": jnp.float32}
NP = {"f64": np.float64, "f32": np.float32}
SOLVE = dict(nev=3, maxiter=60, tol=1e-5, precond="spectral",
             precond_alpha=15.0)
BIT_FOR_BIT = ("ext", "K", "M", "KM", "dot_mm", "dot_cols", "col_norms",
               "dot_vv", "KM_dw")
# shift-invert on the reference's 8 x 5 x 5 brick in 8 slabs
SI_DIMS = dict(nx=8, ny=5, nz=5)
SI_KW = dict(sigma=60.0, nev=3, maxiter=45, tol=1e-7)
TRL_KW = dict(mode="shift_invert", sigma=60.0, nev=1, ncv=8, max_restarts=2,
              tol=1e-30, inner_tol=1e-8)
# the checkpointed LOBPCG on the oracle brick's slabs
CKPT_PENCIL = ("slabs", DIMS, "f64")
CKPT_KW = dict(nev=3, m=7, tol=1e-8, precond="spectral", precond_alpha=15.0)
CKPT_STOP = 4
CKPT_FILES = ["ckpt.npz"] + [f"ckpt.npz.shard{d}" for d in range(D)]
# batched transforms whose product shape holds the slab count, and the
# one-process dot_basis over the stacked rows (see the module docstring)
ROUNDING = ("project", "solve", "solve_sigma", "dot_basis")
ROUNDING_RTOL = {"f64": 1e-13, "f32": 1e-5}


def _cut(name, tmp_dir, **solver):
    """A config of configs/ cut to the 8^3 brick in 4 slabs."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg["problem"].update(nx=8, ny=8, nz=8)
    cfg["dist"]["n_shards"] = 4
    cfg["solver"].update(solver)
    path = tmp_dir / f"{name}_cut.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _reference_start():
    """The reference's start block (its make_block, PRNGKey(0), 7 columns,
    f32) in the global stencil ordering, carried to the ranks through
    inject_vectors."""
    ref = RefDistStencil.build(**DIMS, D=D, dtype=jnp.float32)
    port = DistStencilPencil3D.build(**DIMS, D=D, device="cpu")
    return port.extract_vectors(np.asarray(ref.make_block(
        jax.random.PRNGKey(0), 7)))


@pytest.fixture(scope="module")
def si_reference():
    """The reference's slab shift-invert case on its mesh (f64), with its
    start vector in the stacked layout."""
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    ref = RefDistStencil.build(**SI_DIMS, D=D, dtype=jnp.float64)
    v0 = np.asarray(ref.make_block(jax.random.PRNGKey(0), 1))[:, 0]
    return v0, ref_si_dist(ref, ref_make_mesh(D), **SI_KW)


SCALING_GRID = dict(nx=16, ny=16, nz=16)  # the weak rows' 2-process grid


def _scaling_start():
    """The reference scaling run's start block (its lobpcg_dist's default,
    make_block(PRNGKey(0), m 8) of the f32 pencil in 2 slabs), stacked."""
    ref = RefDistStencil.build(**SCALING_GRID, D=2, dtype=jnp.float32)
    return np.asarray(ref.make_block(jax.random.PRNGKey(0), 8))


def _ckpt_calls(P, tmp_dir, ckpt_dir, write):
    """The checkpointed LOBPCG on the slabs and config 4_stencil (cut)
    through the CLI's rank path into ckpt_dir: stopped by maxiter from the
    reference's start block (write), or resumed from the shard files."""
    kw = {**CKPT_KW, "maxiter": 60}
    argv = [_cut("config4_stencil", tmp_dir), "--device", "cpu", "--procs",
            str(P), "--checkpoint", str(ckpt_dir / "cli.npz")]
    if write:
        start = RefDistStencil.build(**DIMS, D=D, dtype=jnp.float64)
        kw.update(maxiter=CKPT_STOP, checkpoint_every=2, X0=np.asarray(
            start.make_block(jax.random.PRNGKey(0), 7)))
        argv += ["--maxiter", str(CKPT_STOP), "--checkpoint-every", "2"]
    kind = "write" if write else "resume"
    return [(("ckpt", kind), (rt.checkpoint_run, (
        CKPT_PENCIL, D, P, "cpu", str(ckpt_dir / "ckpt.npz"), kw))),
            (("ckpt", f"cli_{kind}"), (rt.cli, (argv,)))]


def _shard_copy(src, dst):
    """A copy of the checkpoint directory without its exit-time files."""
    shutil.copytree(src, dst)
    for name in ("ckpt.npz", "cli.npz"):
        (dst / name).unlink()
    return dst


def _files(ckpt_dir):
    """The names of the files of the checkpoint ckpt.npz in ckpt_dir."""
    return sorted(p.name for p in ckpt_dir.glob("ckpt.npz*"))


def _calls(P, tmp_dir, si_v0, ckpt_dir):
    """[(key, (task, args))] at P ranks: the apply checks and the
    shift-invert runs; at P 1 and 2 the solve from the reference's start
    block, configs 4_stencil and 5 through the CLI's rank path and the
    stopped checkpointed runs into ckpt_dir; at P 4 the resumes from
    ckpt_dir."""
    calls = [("applies", (rt.slab_checks, (DIMS, D, P, "cpu", CASES,
                                           WIDTHS, SEED))),
             ("si", (rt.slab_solves, (SI_DIMS, D, P, "cpu", "f64", {
                 "si": ("shift_invert_lanczos_dist", {**SI_KW, "v0": si_v0}),
                 "trl": ("thick_restart_lanczos_dist",
                         {**TRL_KW, "v0": si_v0})})))]
    if P <= 2:
        calls.append(("solve", (rt.slab_solve, (
            DIMS, D, P, "cpu", SOLVE, 1e-8, "f32", _reference_start()))))
        for name, solver in (("config4_stencil", {}),
                             ("config5", dict(nev=8, batch=4))):
            argv = [_cut(name, tmp_dir, **solver), "--device", "cpu",
                    "--procs", str(P)]
            calls.append((name, (rt.cli, (argv,))))
        calls += _ckpt_calls(P, tmp_dir, ckpt_dir, True)
    if P == 4:
        calls += _ckpt_calls(P, tmp_dir, ckpt_dir, False)
    if P == 2:
        # the scaling row at the reference's 16^3 in 2 slabs, tol 1e-30
        calls.append(("scaling", (scaling.scaling_row, (
            *SCALING_GRID.values(), 2, 4, 40, "cpu", _scaling_start()))))
    return calls


def _run(calls, P):
    tasks = [c for _, c in calls]
    results = (rt.sequence(tasks) if P == 1
               else procs.spawn(rt.sequence, P, tasks, device="cpu"))
    out = {}
    for (key, _), r in zip(calls, results):
        if isinstance(key, tuple):
            out.setdefault(key[0], {})[key[1]] = r
        else:
            out[key] = r
    return out


@pytest.fixture(scope="module")
def one(tmp_path_factory, si_reference):
    """The one-process stacked view, in this process."""
    tmp = tmp_path_factory.mktemp("one")
    out = _run(_calls(1, tmp, si_reference[0], tmp / "ckpt"), 1)
    out["ckpt_dir"] = tmp / "ckpt"
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, si_reference):
    """{P: results} of P gloo ranks, one spawn each for all its checks; P
    4 resumes from a copy of P 2's checkpoints."""
    out = {}
    for P in (2, 4):
        tmp = tmp_path_factory.mktemp(f"p{P}")
        ckpt = tmp / "ckpt"
        if P == 4:
            _shard_copy(out[2]["ckpt_dir"], ckpt)
        out[P] = _run(_calls(P, tmp, si_reference[0], ckpt), P)
        out[P]["ckpt_dir"] = ckpt
    return out


@pytest.fixture(scope="module")
def resumed(spawned, tmp_path_factory):
    """In this process, from a copy of P 2's shard files."""
    ckpt = _shard_copy(spawned[2]["ckpt_dir"],
                       tmp_path_factory.mktemp("resumed") / "ckpt")
    return rt.checkpoint_run(CKPT_PENCIL, D, 1, "cpu",
                             str(ckpt / "ckpt.npz"), {**CKPT_KW,
                                                      "maxiter": 60})


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    return ref_make_mesh(D)


def _ref_pencil(case):
    dtype, materials = CASES[case]
    eps_r, mu_r = materials if materials is not None else (None, None)
    return RefDistStencil.build(**DIMS, D=D, dtype=JNP[dtype], eps_r=eps_r,
                                mu_r=mu_r)


def _block(case, m, seed):
    """slab_checks' block (numpy draws from `seed`) in the global stacked
    layout, at the case's dtype."""
    port = DistStencilPencil3D.build(**DIMS, D=D, device="cpu",
                                     dtype=torch.float64)
    X = np.random.default_rng(seed).standard_normal((port.n_full, m))
    return port.scatter_vector(X).astype(NP[CASES[case][0]])


def _shard_map(ref, mesh, fn, *arrays, out_specs=None):
    row = PS(ref.axis, None)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(ref.partition_specs(),) + (row,) * len(
            arrays), out_specs=row if out_specs is None else out_specs,
        check_vma=False))(ref, *(jnp.asarray(a) for a in arrays))


# --- P processes against one -------------------------------------------------


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
@pytest.mark.parametrize("P", [2, 4])
def test_slab_pencil_matches_one_process_bit_for_bit(spawned, one, P, case):
    got, want = spawned[P]["applies"][case], one["applies"][case]
    assert set(got) == set(want) == set(WIDTHS)
    for m in WIDTHS:
        names = [n for n in BIT_FOR_BIT if n in want[m]]
        if CASES[case][1] is not None:
            names.append("project")  # CG on the loaded pencil
        assert set(names) <= set(got[m])
        for name in names:
            g, w = got[m][name], want[m][name]
            assert g.shape == w.shape and g.dtype == w.dtype, (m, name)
            assert np.array_equal(g, w), (m, name)
    vacuum = CASES[case][1] is None
    assert ("solve" in want[WIDTHS[0]]) == vacuum


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
@pytest.mark.parametrize("P", [2, 4])
def test_slab_pencil_matches_one_process_to_rounding(spawned, one, P, case):
    """What goes through a batched slab transform (the vacuum projection's
    fast nodal solve, the spectral solves) or dot_basis: within
    ROUNDING_RTOL of max|one process|."""
    tol = ROUNDING_RTOL[CASES[case][0]]
    for m in WIDTHS:
        for name in ROUNDING:
            if name not in one["applies"][case][m]:
                continue
            g = spawned[P]["applies"][case][m][name]
            w = one["applies"][case][m][name]
            assert g.shape == w.shape and g.dtype == w.dtype, (m, name)
            assert np.abs(g - w).max() <= tol * np.abs(w).max(), (m, name)


@pytest.mark.parametrize("P", [2, 4])
def test_ghost_byte_counter_per_apply_is_halo_bytes(spawned, one, P):
    """What each rank's link pushed in one fused f32 apply: halo_bytes()
    of the comm model for a rank with two neighbours, half of it at the
    chain ends, nothing in one process; the apply gathers nothing. A
    projection gathers projector_gather_bytes(D) and a spectral solve
    spectral_gather_bytes(D) to every rank."""
    for m in WIDTHS:
        got = spawned[P]["applies"][1][m]  # f32 vacuum
        cm = CommModel(ny=DIMS["ny"], nz=DIMS["nz"], cells=DIMS["nx"] // D,
                       m=m, t_compute_iter_s=1.0)
        want = [cm.halo_bytes()] * P
        want[0] = want[-1] = cm.halo_bytes() // 2
        assert got["push_bytes_KM"].tolist() == want
        assert got["gathers_KM"].tolist() == [0] * P
        assert got["gather_bytes_project"].tolist() == [
            cm.projector_gather_bytes(D)] * P
        assert got["gather_bytes_solve"].tolist() == [
            cm.spectral_gather_bytes(D)] * P
        assert one["applies"][1][m]["push_bytes_KM"].tolist() == [0]


def test_solve_and_refine_match_one_process(spawned, one):
    got, want = spawned[2]["solve"], one["solve"]
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=1e-5)
    assert got["converged"] and got["refined_residuals"].max() <= 1e-8
    np.testing.assert_allclose(got["refined_eigenvalues"],
                               want["refined_eigenvalues"], rtol=1e-12)
    assert got["refined_eigenvectors"].shape == (
        want["refined_eigenvectors"].shape)
    # every rank ran the same plain applies, as many times, and no kernel
    counts = got["counts"]
    assert len(counts) == 2 and counts[0] == counts[1]
    assert not any(counts[0].values())


def test_refine_matches_reference(spawned, mesh):
    """The reference's refinement of the P-process LOBPCG block on its
    mesh: the same eigenvalues and sweeps."""
    got = spawned[2]["solve"]
    ref = RefDistStencil.build(**DIMS, D=D, dtype=jnp.float32)
    want = ref_refine_dw_dist(ref, mesh, got["eigenvectors"], tol=1e-8)
    assert want.converged
    np.testing.assert_allclose(got["refined_eigenvalues"], want.eigenvalues,
                               rtol=1e-11)
    assert got["refine_iterations"] == want.iterations


@pytest.mark.parametrize("name", ["config4_stencil", "config5"])
def test_cli_on_two_processes_matches_one(spawned, one, name):
    """The cut config through the CLI's rank path with --procs 2 (every
    rank refines: refine_dw_dist is a collective): rank 0's history and
    report against the one-process run's."""
    (hist, rep), (hist1, rep1) = spawned[2][name], one[name]
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert rep["iterations"] == rep1["iterations"]
    assert [h.get("phase") for h in hist] == [h.get("phase") for h in hist1]
    np.testing.assert_allclose([h["max_rel_res"] for h in hist],
                               [h["max_rel_res"] for h in hist1], rtol=1e-9)
    np.testing.assert_allclose(rep["eigenvalues"], rep1["eigenvalues"],
                               rtol=1e-12)
    assert rep["n"] == rep1["n"] == 3 * 8 * 9 * 9


def test_cli_main_runs_the_slab_road_on_two_processes(tmp_path, capsys,
                                                      one):
    """The --procs refusal is lifted for the slab road: main() spawns the
    ranks and prints rank 0's history and report."""
    path = _cut("config4_stencil", tmp_path)
    assert port_cli.main([path, "--device", "cpu", "--procs", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(lines[-1])
    assert len(lines) - 1 == len(one["config4_stencil"][0])
    np.testing.assert_allclose(rep["eigenvalues"],
                               one["config4_stencil"][1]["eigenvalues"],
                               rtol=1e-12)


def _nearest(vals, sigma, k):
    return np.sort(vals[np.argsort(np.abs(vals - sigma))[:k]])


@pytest.mark.parametrize("P", [2, 4])
def test_shift_invert_on_slabs_matches_reference(spawned, si_reference, P):
    """The reference's slab case on P processes: converged, within 1e-7 of
    the reference's eigenvalues and of the dense spectrum's nearest to
    sigma (the degenerate 61.94 pair included)."""
    got = spawned[P]["si"]["si"]
    assert got["converged"], got["residuals"]
    np.testing.assert_allclose(np.sort(got["eigenvalues"]),
                               np.sort(si_reference[1].eigenvalues),
                               rtol=1e-7)
    cav = BrickCavity3D(**SI_DIMS)
    w = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(),
                          eigvals_only=True)
    np.testing.assert_allclose(
        np.sort(got["eigenvalues"]),
        _nearest(np.sort(w[w > 1e-8]), SI_KW["sigma"], SI_KW["nev"]),
        rtol=1e-7)
    n_full = DistStencilPencil3D.build(**SI_DIMS, D=D, device="cpu").n_full
    assert got["eigenvectors"].shape == (n_full, SI_KW["nev"])


@pytest.mark.parametrize("run", ["si", "trl"])
@pytest.mark.parametrize("P", [2, 4])
def test_shift_invert_on_slabs_matches_one_process(spawned, one, P, run):
    """shift_invert_lanczos_dist and thick_restart_lanczos_dist(mode=
    "shift_invert") on P processes against one: the eigenvalues within
    1e-9 (f64), as many steps; every rank made the same gathers and
    exchanges."""
    got, want = spawned[P]["si"][run], one["si"][run]
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=1e-9)
    assert got["iterations"] == want["iterations"]
    assert len(set(got["gathers"])) == 1 and got["gathers"][0] > 0
    assert want["gathers"] == [0]
    assert all(c == got["counts"][0] for c in got["counts"])


def test_checkpoint_shards_on_slabs_match_one_process(spawned, one):
    """The stopped run at P 2 leaves the D shard files one process writes
    from the same start: theta within 1e-12 relative, each column of X
    within 1e-12 of max|X| up to its sign (a Ritz vector's sign is
    eigh's choice, and rounding in the Gram matrices, near the identity
    after SVQB, flips it: measured, every column flipped, 8.7e-13 of max
    after the flip); those files and the exit-time file, and no other."""
    got, want = spawned[2]["ckpt"]["write"], one["ckpt"]["write"]
    assert got["iterations"] == want["iterations"] == CKPT_STOP
    for name in CKPT_FILES:
        a = load_state(str(spawned[2]["ckpt_dir"] / name))
        b = load_state(str(one["ckpt_dir"] / name))
        assert a["iteration"] == b["iteration"] == CKPT_STOP, name
        assert a["X"].shape == b["X"].shape, name
        gap = np.minimum(np.abs(a["X"] - b["X"]).max(axis=0),
                         np.abs(a["X"] + b["X"]).max(axis=0))
        assert gap.max() <= 1e-12 * np.abs(b["X"]).max(), name
        np.testing.assert_allclose(a["theta"], b["theta"], rtol=1e-12)
    for run in (spawned[2], one):
        assert _files(run["ckpt_dir"]) == sorted(CKPT_FILES)


def test_checkpoint_on_slabs_resumes_at_another_process_count(
        spawned, resumed):
    """From P 2's shard files (the exit-time file removed), at P 4 and in
    one process: both start at the saved iteration, take as many
    iterations and converge, their eigenvalues within 1e-12 of each
    other's."""
    p4, p1 = spawned[4]["ckpt"]["resume"], resumed
    for r in (p4, p1):
        assert r["history"][0][0] == CKPT_STOP
        assert r["converged"] and r["residuals"].max() <= 1e-8
    assert p4["iterations"] == p1["iterations"]
    np.testing.assert_allclose(p4["eigenvalues"], p1["eigenvalues"],
                               rtol=1e-12)
    # the resume wrote the exit-time file (removed before it) and left the
    # shard files as P 2 wrote them
    assert _files(spawned[4]["ckpt_dir"]) == sorted(CKPT_FILES)
    for name in CKPT_FILES[1:]:
        assert ((spawned[4]["ckpt_dir"] / name).stat().st_mtime_ns
                == (spawned[2]["ckpt_dir"] / name).stat().st_mtime_ns), name


def test_cli_checkpoint_on_slabs_resumes_with_more_processes(spawned,
                                                            one):
    """Config 4_stencil (cut) through the CLI with --procs 2 --checkpoint,
    stopped by --maxiter (then refined, as the config says), and resumed
    with --procs 4 from its shard files: rank 0's history starts at the
    saved iteration; the eigenvalues within 1e-10 of the one-process
    run's."""
    hist2, _ = spawned[2]["ckpt"]["cli_write"]
    hist4, rep4 = spawned[4]["ckpt"]["cli_resume"]
    assert [h["iter"] for h in hist2 if "phase" not in h] == list(
        range(CKPT_STOP))
    assert all((spawned[2]["ckpt_dir"] / f"cli.npz.shard{d}").exists()
               for d in range(4))
    assert hist4[0]["iter"] == CKPT_STOP
    assert rep4["converged"] and max(rep4["residuals"]) <= 1e-8
    np.testing.assert_allclose(rep4["eigenvalues"],
                               one["config4_stencil"][1]["eigenvalues"],
                               rtol=1e-10)


# --- P processes against the reference ---------------------------------------


@pytest.mark.parametrize("which", ["K", "M", "KM"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
@pytest.mark.parametrize("P", [2, 4])
def test_applies_match_reference(spawned, mesh, P, case, which):
    ref, m = _ref_pencil(case), 3
    X = _block(case, m, SEED + m)
    if which == "KM":
        want = _shard_map(ref, mesh, lambda p, Xl: p.KM_mm(Xl), X,
                          out_specs=(PS(ref.axis, None),) * 2)
    else:
        want = (_shard_map(ref, mesh, lambda p, Xl: getattr(
            p, f"{which}_mm")(Xl), X),)
    got = spawned[P]["applies"][case][m][which]
    got = got if which == "KM" else got[None]
    for g, w in zip(got, want):
        w = np.asarray(w)
        if CASES[case][0] == "f64":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
        else:
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("case", [0, 2], ids=["vacuum", "materials"])
@pytest.mark.parametrize("P", [2, 4])
def test_project_matches_reference(spawned, mesh, P, case):
    """Exact fast nodal solve (vacuum) and nodal CG (materials)."""
    ref, m = _ref_pencil(case), 3
    want = np.asarray(_shard_map(ref, mesh, lambda p, Xl: p.project(Xl),
                                 _block(case, m, SEED + m)))
    got = spawned[P]["applies"][case][m]["project"]
    if CASES[case][1] is None:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    else:
        assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()


@pytest.mark.parametrize("P", [2, 4])
def test_reductions_match_reference(spawned, mesh, P):
    ref, m = _ref_pencil(0), 3
    A, B = _block(0, m, SEED + m), _block(0, m, SEED + 100 + m)
    rep = PS()
    ref_mm, ref_cols, ref_sq = _shard_map(
        ref, mesh, lambda p, a, b: (p.dot_mm(a, b), p.dot_cols(a, b),
                                    p.dot_cols(a, a)), A, B,
        out_specs=(rep, rep, rep))
    got = spawned[P]["applies"][0][m]
    np.testing.assert_allclose(got["dot_mm"], np.asarray(ref_mm),
                               rtol=1e-12)
    np.testing.assert_allclose(got["dot_cols"], np.asarray(ref_cols),
                               rtol=1e-12)
    np.testing.assert_allclose(got["dot_vv"], np.asarray(ref_cols)[0],
                               rtol=1e-12)
    np.testing.assert_allclose(got["col_norms"] ** 2, np.asarray(ref_sq),
                               rtol=1e-12)


@pytest.mark.parametrize("kind", ["solve", "solve_sigma"])
@pytest.mark.parametrize("P", [2, 4])
def test_spectral_solves_match_reference(spawned, mesh, P, kind):
    ref, m = _ref_pencil(0), 3
    R = _block(0, m, SEED + m)
    row = PS(ref.axis, None)
    if kind == "solve":
        sol, args, specs = RefShift.build(ref, ALPHA), (), ()
        fn = lambda p, s, Rl: s.solve(p, Rl)
    else:
        sol = RefShift.build(ref, 0.0)
        args = (jnp.asarray(np.linspace(3.0, 40.0, m)),)
        specs = (PS(),)
        fn = lambda p, s, Rl, sg: s.solve_sigma(p, Rl, sg)
    want = np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(ref.partition_specs(), sol.partition_specs(), row) + specs,
        out_specs=row, check_vma=False))(ref, sol, jnp.asarray(R), *args))
    got = spawned[P]["applies"][0][m][kind]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * scale)


# --- the scaling harness and the comm model ----------------------------------


def test_comm_model_equals_the_reference():
    for kw in (dict(ny=16, nz=16, cells=8, m=6, t_compute_iter_s=0.02),
               dict(ny=32, nz=24, cells=4, m=9, t_compute_iter_s=1e-3,
                    bw_ici=2e9, bw_dcn=5e8, overlap_halo=0.25)):
        got, want = CommModel(**kw), RefCommModel(**kw)
        assert got.halo_bytes() == want.halo_bytes()
        assert got.projector_permute_bytes() == want.projector_permute_bytes()
        for Dn in (1, 2, 3, 8, 64):
            assert got.spectral_psum_bytes(Dn) == want.spectral_psum_bytes(Dn)
            assert (got.projector_psum_bytes(Dn)
                    == want.projector_psum_bytes(Dn))
            for hosts in (1, 2):
                assert got.t_iter(Dn, hosts) == want.t_iter(Dn, hosts)
                assert (got.weak_efficiency(Dn, hosts)
                        == want.weak_efficiency(Dn, hosts))
        sizes = (1, 2, 4, 8, 16)
        assert got.report(sizes) == want.report(sizes)
        assert got.report(sizes, lambda d: d) == want.report(sizes,
                                                             lambda d: d)


def test_scaling_row_does_not_break_down_past_the_floor(spawned):
    """The reference's scaling.run body (lobpcg_dist, nev 4, alpha 15,
    tol 1e-30, 40 iterations, f32) at 16^3 in 2 slabs on its CPU mesh,
    against the port's scaling_row on 2 processes from the same start
    block: both reach the f32 floor and bounce there without breaking
    down (measured: the last 10 iterations' max residual 6.1e-6 and
    1.4e-6, against 0.958 in the card's breakdown of the port's row)."""
    ref = RefDistStencil.build(**SCALING_GRID, D=2, dtype=jnp.float32)
    want = ref_lobpcg_dist(ref, ref_make_mesh(2), nev=4, maxiter=40,
                           tol=1e-30, precond_alpha=15.0)
    got = spawned[2]["scaling"]
    ref_hist = [h["max_rel_res"] for h in want.history]
    assert got["solve_iters"] == len(got["history"]) == len(ref_hist) == 40
    for hist in (ref_hist, got["history"]):
        assert min(hist) < 1e-5
        assert max(hist[-10:]) < 1e-4
    np.testing.assert_allclose(got["history"][0], ref_hist[0], rtol=1e-5)


def test_scaling_rows_carry_the_reference_keys(tmp_path):
    root = ROOT / "scaling_results.json"
    before = hashlib.sha256(root.read_bytes()).hexdigest()
    out = tmp_path / "scaling.json"
    rep = scaling.run("weak", cells=2, ny=4, nz=3, nev=2, maxiter=3,
                      procs=(1, 2), device="cpu", out=out)
    keys = {"devices", "grid", "n", "nnz_eff", "t_km_apply_s", "nnz_per_s",
            "t_solve_s", "t_iter_s", "solve_iters", "max_res", "efficiency",
            "dcn_links", "hosts"}
    assert [r["devices"] for r in rep["rows"]] == [1, 2]
    for row in rep["rows"]:
        assert keys <= set(row)
        assert row["shared_card"] is False  # the CPU: no card to share
        assert row["solve_iters"] == 3 and np.isfinite(row["t_solve_s"])
    assert rep["rows"][0]["efficiency"] == 1.0
    assert rep["rows"][1]["grid"] == [4, 4, 3]
    assert rep["simulated"] is True and rep["mode"] == "weak"
    assert [r["devices"] for r in rep["predicted_weak_scaling"]] == [
        1, 2, 8, 16, 32, 64]
    assert json.loads(out.read_text())["rows"] == json.loads(
        json.dumps(rep["rows"]))
    assert hashlib.sha256(root.read_bytes()).hexdigest() == before
