"""The distributed roads across hosts (maxwell_tpu_torch/dist/procs.py with
a Rendezvous; dist/mesh.py's host topology; kernels/halo.py HaloLink's
route per side), held on one machine: run_hosts starts two launcher
processes that act as hosts 0 and 1 and meet at a TCPStore on 127.0.0.1
at a free port, each spawning its gloo ranks on the CPU, H = 2 hosts of 1
and of 2 ranks, D = 8 shards (or slabs).

Bounds:
- ranks are hosts-major (rank = h * procs + local rank), each knows its
  host and the ranks that share it, and binds the CPU;
- the port's mesh_topology_report gives the reference's keys
  (maxwell_tpu.dist.mesh.mesh_topology_report) on a stand-in mesh whose D
  devices carry the same process_index layout, and partition_problem's
  derived dcn_links equal the reference's derivation on that stand-in;
- an exchange (both layouts) and a K apply across hosts make no gather:
  the link's own transport carries the halo, the sides that cross hosts
  counted in bytes_across_hosts, the others in bytes_pushed;
- halos through every transport, the K, M and fused applies, the fused
  interior SpMM + halo section, the reductions and the projection: bit
  for bit one process (as tests/test_torch_dist_procs.py holds P ranks on
  one host);
- lobpcg_dist on the union ("rdma_overlap") and "pallas" ("rdma") pencils
  of the 16 x 16 rectangle across 2 x 2: within 1e-5 relative of one
  process (f32, the solve's tolerance) and within
  test_torch_dist_solve.py's bounds (2e-5 of the reference's, 1e-4 of the
  dense spectrum) of the reference's lobpcg_dist with dcn_links=(3,) on
  its 8-device CPU mesh, from the reference's start block;
- the slab pencil across 2 x 2 (the oracle brick of
  test_torch_dist_stencil_procs.py): bit for bit one process in the
  ghost blocks, applies and dots, and within 1e-13 (f64) / 1e-5 (f32) of
  max|one process| in the batched transforms and dot_basis;
- at 2 x 2 on the card K5/K6 push a side only to a neighbour on the
  host (the flags follow the routes), and a side on the host whose
  neighbour's buffer is not mapped raises;
- a rank that raises on host 1 makes host 0's launcher raise RankError
  within 60 s (not after the collectives' timeout);
- the dry run's branches on two hosts of one rank, mesh_processes
  against the hosts the spawn's ranks span;
- config 4 (cut to the 6^3 brick, f64) through the CLI on two hosts of
  one rank, host 1 a `python -m maxwell_tpu_torch.cli.run --host 1`
  process: as test_torch_dist_procs.py holds --procs 2, the iterations
  of one process and its eigenvalues within 1e-12; host 1 prints
  nothing;
- bench/scaling.py's row on two hosts of one rank: it carries the mesh's
  real hosts (2) and dcn_links (1), and its ranks' ghost planes cross
  the host boundary (km_apply_bytes_across_hosts), one plane set a rank.
"""

import json
import os
import subprocess
import sys
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
from maxwell_tpu.dist.mesh import mesh_topology_report as ref_report
from maxwell_tpu.problems import RectCavity2D as RefRect
from maxwell_tpu.solvers.dist_solve import lobpcg_dist as ref_lobpcg_dist
from maxwell_tpu_torch.bench import scaling
from maxwell_tpu_torch.bench.comm_model import CommModel
from maxwell_tpu_torch.cli import run as port_cli
from maxwell_tpu_torch.dist import procs
from maxwell_tpu_torch.dist import rank_tasks as rt
from maxwell_tpu_torch.entry import dryrun_branches
from maxwell_tpu_torch.kernels import halo
from maxwell_tpu_torch.problems import RectCavity2D

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
D = 8
CASES = [("ref", "ppermute", "f64"), ("pallas", "rdma", "f32"),
         ("union", "rdma_overlap", "f32"), ("union", "ppermute", "f32")]
SPECS = {"rect16": ("rect", 16), "brick6": ("brick", 6)}
LAYOUTS = {"2x1": (2, 1), "2x2": (2, 2)}  # hosts x ranks a host
SOLVE_KW = dict(nev=3, maxiter=60, tol=1e-5, precond_alpha=10.0)
SOLVES = {"union": ("union", "rdma_overlap"), "pallas": ("pallas", "rdma")}
# the slab pencil: tests/test_torch_dist_stencil_procs.py's oracle brick
DIMS = dict(a=1.0, b=1.1, c_len=0.9, nx=16, ny=5, nz=4)
_rng = np.random.default_rng(5)
MATERIALS = (1.0 + _rng.random((16, 5, 4)), 1.0 + _rng.random((16, 5, 4)))
SLAB_CASES = [("f64", None), ("f32", None), ("f64", MATERIALS)]
SLAB_BIT_FOR_BIT = ("ext", "K", "M", "KM", "dot_mm", "dot_cols",
                    "col_norms", "dot_vv", "KM_dw")
SLAB_ROUNDING = ("project", "solve", "solve_sigma", "dot_basis")
SLAB_RTOL = {"f64": 1e-13, "f32": 1e-5}


def _shard_hosts(hosts, per_host):
    """The host of each of the D shards of a mesh over hosts * per_host
    ranks (D / P consecutive shards a rank, hosts-major ranks)."""
    per_rank = D // (hosts * per_host)
    return [d // per_rank // per_host for d in range(D)]


class _Device:
    def __init__(self, i, process_index):
        self.id, self.process_index = i, process_index


class _StandInMesh:
    """What the reference's mesh_topology_report reads of a JAX mesh: its
    devices and their process_index."""

    def __init__(self, process_index):
        self.devices = np.array([_Device(i, p)
                                 for i, p in enumerate(process_index)])


@pytest.fixture(scope="module")
def reference():
    """The reference's f32 distributed LOBPCG on the 16 x 16 rectangle with
    its link 3 crossing hosts (dcn_links=(3,)), and its start block."""
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    ref = ref_partition(RefRect(nx=16, ny=16), D, block=8,
                        dtype=jnp.float32, dcn_links=(3,))
    X0 = np.asarray(ref.make_block(jax.random.PRNGKey(0), 7))
    return X0, ref_lobpcg_dist(ref, ref_make_mesh(D), **SOLVE_KW)


def _calls(P, X0, layout):
    """[(key, (task, args))] on P ranks in all: every rank's place, the
    applies and links of both problems; at 2 x 2 also the solves and the
    slab checks."""
    calls = [("places", (rt.places, ()))] if P > 1 else []
    calls += [(("applies", s), (rt.apply_checks, (SPECS[s], D, P, "cpu",
                                                   CASES)))
              for s in SPECS]
    calls.append((("links", "rect16"), (rt.link_checks, (
        SPECS["rect16"], D, P, "cpu", CASES))))
    if layout == "2x2":
        calls += [(("solves", k), (rt.solve_checks, (
            SPECS["rect16"], D, P, "cpu", kernel, impl, "f32",
            {"lobpcg": ("lobpcg_dist", {**SOLVE_KW, "X0": X0})})))
            for k, (kernel, impl) in SOLVES.items()]
        calls.append(("slabs", (rt.slab_checks, (DIMS, D, P, "cpu",
                                                 SLAB_CASES))))
    return calls


def _filed(calls, results):
    out = {}
    for (key, _), r in zip(calls, results):
        if isinstance(key, tuple):
            out.setdefault(key[0], {})[key[1]] = r
        else:
            out[key] = r
    return out


@pytest.fixture(scope="module")
def one(reference):
    """The one-process stacked view, in this process."""
    calls = _calls(1, reference[0], "2x2")
    return _filed(calls, rt.sequence([c for _, c in calls]))


@pytest.fixture(scope="module")
def hosts(reference):
    """{layout: results}: one run_hosts call a layout, all its checks in
    one sequence; the wall seconds of each."""
    out = {}
    for name, (H, per) in LAYOUTS.items():
        calls = _calls(H * per, reference[0], name)
        t0 = time.perf_counter()
        res = procs.run_hosts(rt.sequence, H, per, [c for _, c in calls],
                              device="cpu")
        out[name] = {**_filed(calls, res),
                     "seconds": time.perf_counter() - t0}
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_are_hosts_major(hosts, layout):
    H, per = LAYOUTS[layout]
    places = hosts[layout]["places"]
    assert [p["rank"] for p in places] == list(range(H * per))
    for p in places:
        h = p["rank"] // per
        assert p["procs"] == H * per and p["hosts"] == H
        assert p["host"] == h
        assert p["host_ranks"] == list(range(h * per, (h + 1) * per))
        assert p["device"] == "cpu"
    assert len({p["pid"] for p in places}) == H * per


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_topology_report_equals_the_reference(hosts, layout):
    H, per = LAYOUTS[layout]
    want = ref_report(_StandInMesh(_shard_hosts(H, per)))
    assert want["hosts"] == H and want["dcn_links"] == H - 1
    for ranks in hosts[layout]["links"]["rect16"].values():
        for r in ranks:
            got = dict(r["report"])
            assert got.pop("real") == {"devices": H * per, "hosts": H}
            assert got == want
            # p = (k + 1) D / H - 1 for k < H - 1
            assert got["dcn_link_positions"] == [
                (k + 1) * D // H - 1 for k in range(H - 1)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_derived_dcn_links_equal_the_reference(hosts, layout):
    H, per = LAYOUTS[layout]
    stand_in = _StandInMesh(_shard_hosts(H, per))
    want = ref_partition(RefRect(nx=16, ny=16), D, block=8,
                         dtype=jnp.float32, mesh=stand_in).dcn_links
    for ranks in hosts[layout]["links"]["rect16"].values():
        assert all(tuple(r["dcn_links"]) == tuple(want) for r in ranks)


def test_one_host_mesh_keeps_no_dcn_links(one):
    for ranks in one["links"]["rect16"].values():
        (r,) = ranks
        assert r["dcn_links"] == [] and r["routes"] is None
        assert r["report"]["hosts"] == 1


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_exchange_across_hosts_gathers_nothing(hosts, layout, case):
    """Every rank's sides: the ones to another host cross (counted in
    bytes_across_hosts), the others stay on the host (bytes_pushed); an
    exchange and a K apply gather nothing."""
    H, per = LAYOUTS[layout]
    P = H * per
    ranks = hosts[layout]["links"]["rect16"][case]
    esize = 8 if case[2] == "f64" else 4
    for r in ranks:
        q = r["rank"]
        host = q // per
        crosses = {"left": q > 0 and (q - 1) // per != host,
                   "right": q < P - 1 and (q + 1) // per != host}
        assert r["crosses"] == crosses
        assert r["routes"] == {
            "left": None if q == 0 else "gloo",
            "right": None if q == P - 1 else "gloo"}
        sides = {"left": q > 0, "right": q < P - 1}
        for name, moved in r["moved"].items():
            assert moved["gathers"] == 0, (q, name)
            assert moved["bytes_gathered"] == 0, (q, name)
        # one exchange: Hb rows of width m a side
        row_bytes = r["moved"]["exchange_own"]["bytes_pushed"] + r[
            "moved"]["exchange_own"]["bytes_across_hosts"]
        n_sides = sum(sides.values())
        assert row_bytes % max(n_sides, 1) == 0
        each = row_bytes // max(n_sides, 1)
        assert each > 0 and each % (3 * esize) == 0
        moved = r["moved"]["exchange_lr"]
        assert moved["bytes_across_hosts"] == each * sum(
            crosses[s] for s in sides)
        assert moved["bytes_pushed"] == each * sum(
            sides[s] and not crosses[s] for s in sides)


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_applies_and_reductions_match_one_process(hosts, one, layout, spec,
                                                  case):
    got = hosts[layout]["applies"][spec][case]
    want = one["applies"][spec][case]
    assert set(got) == set(want)
    for m in want:
        assert set(got[m]) == set(want[m])
        for name, w in want[m].items():
            g = got[m][name]
            assert g.shape == w.shape and g.dtype == w.dtype, (m, name)
            assert np.array_equal(g, w), (m, name)


def _dense(k):
    cav = RectCavity2D(nx=16, ny=16)
    w = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(),
                          eigvals_only=True)
    return np.sort(w[w > 1e-8])[:k]


@pytest.mark.parametrize("kernel", list(SOLVES))
def test_lobpcg_across_hosts_matches_one_process_and_reference(
        hosts, one, reference, kernel):
    got = hosts["2x2"]["solves"][kernel]["lobpcg"]
    want = one["solves"][kernel]["lobpcg"]
    assert got["converged"], got["residuals"]
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["eigenvalues"],
                               reference[1].eigenvalues, rtol=2e-5)
    np.testing.assert_allclose(got["eigenvalues"], _dense(3), rtol=1e-4)
    # the assembled road across hosts is the one process's, bit for bit
    assert got["history"] == want["history"]
    assert np.array_equal(got["eigenvalues"], want["eigenvalues"])
    impl_kernel = ("union_interior_overlap_ref" if kernel == "union"
                   else "ring_shift_ref")
    assert all(c[impl_kernel] > 0 for c in got["counts"])


@pytest.mark.parametrize("case", range(len(SLAB_CASES)),
                         ids=["f64", "f32", "f64-materials"])
def test_slab_pencil_across_hosts_matches_one_process(hosts, one, case):
    got, want = hosts["2x2"]["slabs"][case], one["slabs"][case]
    assert set(got) == set(want)
    dtype, materials = SLAB_CASES[case]
    for m in want:
        bitwise = [n for n in SLAB_BIT_FOR_BIT if n in want[m]]
        if materials is not None:
            bitwise.append("project")  # CG on the loaded pencil
        for name in bitwise:
            assert np.array_equal(got[m][name], want[m][name]), (m, name)
        for name in SLAB_ROUNDING:
            if name in bitwise or name not in want[m]:
                continue
            g, w = got[m][name], want[m][name]
            assert g.shape == w.shape and g.dtype == w.dtype, (m, name)
            assert np.abs(g - w).max() <= SLAB_RTOL[dtype] * np.abs(
                w).max(), (m, name)


def test_slab_ghosts_cross_hosts_on_the_host_link(hosts):
    """One fused apply: the two ranks beside the host boundary (1 and 2)
    send their ghost planes across it, the others only on their host; the
    apply gathers nothing."""
    for m, r in hosts["2x2"]["slabs"][1].items():  # f32 vacuum
        across = r["across_bytes_KM"].tolist()
        pushed = r["push_bytes_KM"].tolist()
        assert across[0] == across[3] == 0
        assert across[1] == across[2] > 0
        assert pushed[1] == pushed[2] == across[1]
        assert pushed[0] == pushed[3] == across[1]
        assert r["gathers_KM"].tolist() == [0] * 4


def test_a_rank_that_raises_on_one_host_ends_the_other():
    with pytest.raises(procs.RankError, match="host 0's launcher") as err:
        procs.run_hosts(rt.raise_on, 2, 1, 1, "the drill's error",
                        device="cpu", timeout=120)
    outcomes = {o["host"]: o for o in err.value.hosts}
    assert set(outcomes) == {0, 1}
    for h in (0, 1):
        o = outcomes[h]
        assert not o["ok"] and o["error"] == "RankError"
        assert "rank 1 of 2 on host 1 failed" in o["message"]
        assert "ValueError: the drill's error" in o["message"]
    assert outcomes[0]["seconds"] < 60  # not the collectives' timeout


@pytest.mark.parametrize("rank,routes,pushes", [
    (0, (None, "ipc"), (0, 1)), (1, ("ipc", "host_staged"), (1, 0)),
    (2, ("host_staged", "ipc"), (0, 1)), (3, ("ipc", None), (1, 0))])
def test_push_flags_follow_the_routes(rank, routes, pushes):
    """At 2 x 2 on the card a launch pushes a side (K5/K6's push_left,
    push_right) only to a neighbour on its host; the host-staged side and
    a chain end push nothing."""
    group = procs.RankGroup(rank, 4, torch.device("cuda", 0), rank // 2, 2)
    link = halo.HaloLink(group, D, 4, 1)
    assert (link.routes["left"], link.routes["right"]) == routes
    assert link.pushes() == pushes


def test_a_same_host_side_without_its_buffer_raises():
    """A side on the host whose neighbour's buffer is not mapped raises:
    the exchange never skips it."""
    group = procs.RankGroup(1, 4, torch.device("cuda", 0), 0, 2)
    link = halo.HaloLink(group, D, 4, 1)
    bufs = halo._Buffers(torch.zeros(8), None, None)
    with pytest.raises(RuntimeError, match="left neighbour shares this host"):
        link.peer(bufs, "left")


def test_dryrun_across_two_hosts():
    """The dry run's branches on two hosts of one rank: every check passes,
    mesh_processes against the hosts the spawn's ranks span."""
    checks = procs.run_hosts(dryrun_branches, 2, 1, 2, "cpu", 2,
                             device="cpu")
    assert checks["mesh_processes"] is True
    assert all(v is True or v == 0.0 for v in checks.values()), checks


def test_rendezvous_checks_its_host():
    with pytest.raises(ValueError, match="host 2 of 2"):
        procs.Rendezvous("127.0.0.1", 29500, 2, 2)
    with pytest.raises(ValueError, match="port"):
        procs.Rendezvous("127.0.0.1", 0, 2, 0)


def test_gloo_binds_the_interface_toward_the_store():
    assert procs._interface_to("127.0.0.1", 29500) == "lo"


def _config4(tmp_path) -> str:
    """Config 4 as written (f64, 8 shards), cut to the 6^3 brick and 3
    pairs, as test_torch_dist_procs.py cuts it."""
    cfg = json.loads((ROOT / "configs" / "config4.json").read_text())
    cfg["problem"].update(nx=6, ny=6, nz=6)
    cfg["solver"].update(nev=3, maxiter=60)
    path = tmp_path / "config4_small.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_config4_across_two_hosts(tmp_path, capsys):
    config = _config4(tmp_path)
    port = procs.free_port()
    argv = [config, "--device", "cpu", "--hosts", "2", "--rendezvous",
            f"127.0.0.1:{port}"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    host1 = subprocess.Popen(
        [sys.executable, "-m", "maxwell_tpu_torch.cli.run", *argv,
         "--host", "1"], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        assert port_cli.main([*argv, "--host", "0"]) == 0
        out1, _ = host1.communicate(timeout=120)
    finally:
        if host1.poll() is None:
            host1.kill()
    assert host1.returncode == 0 and out1 == ""
    lines = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(lines[-1])
    rep1 = port_cli.run([config, "--device", "cpu"])[1]
    assert rep["converged"] and max(rep["residuals"]) <= 1e-8
    assert len(lines) - 1 == rep["iterations"] == rep1["iterations"]
    np.testing.assert_allclose(rep["eigenvalues"], rep1["eigenvalues"],
                               rtol=1e-12)
    assert rep["n"] == rep1["n"]


def test_scaling_rows_carry_the_real_hosts():
    args = (4, 4, 3)  # the weak rows' 2-slab grid, 2 cells a slab
    one = scaling.scaling_row(*args, 1, 2, 3, "cpu")
    two = procs.run_hosts(scaling.scaling_row, 2, 1, *args, 2, 2, 3, "cpu",
                          device="cpu")
    assert (one["hosts"], one["dcn_links"]) == (1, 0)
    assert (two["hosts"], two["dcn_links"]) == (2, 1)
    cm = CommModel(ny=4, nz=3, cells=2, m=scaling.APPLY_M,
                   t_compute_iter_s=1.0)
    # one slab a rank: each rank's one side crosses the host boundary
    assert two["km_apply_bytes_across_hosts_per_rank"] == [
        cm.halo_bytes() // 2] * 2
    assert two["km_apply_bytes_pushed_per_rank"] == [0, 0]
    assert two["solve_iters"] == 3 and np.isfinite(two["t_solve_s"])
