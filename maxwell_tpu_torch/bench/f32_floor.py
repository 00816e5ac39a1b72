"""Which dense op sets the card's f32 floor of the distributed LOBPCG on the
8-shard 16x16 rectangle. With the small eigh in f32 it stalled near 1-2e-5
on the card and reached 5e-6 on the CPU; solvers/rr.small_eigh now runs
that eigh in f64 (tests/test_torch_cuda.py holds the card to 1e-5).

The solve is lobpcg_dist's loop (solvers/lobpcg.lobpcg_run) at the cuda
test's knobs: nev 3, block 7 from one seeded numpy X0, tol 1e-5, maxiter
60, stall_window 8, the shifted-CG preconditioner (alpha 10, 20 sweeps).
Each run places its parts on the card or the CPU:

  card, cpu               everything on one side (small_eigh in f64)
  dense_cpu_applies_card  LOBPCG's dense algebra (Gram products, SVQB and
                          Rayleigh-Ritz eigh, rotations, residual norms) on
                          the CPU, the operator applies (K, M, KM,
                          projector, preconditioner) on the card
  dense_card_applies_cpu  the reverse
  card_eigh_cpu           on the card, small_eigh on the CPU
  card_eigh_f32           on the card, the eigh in f32 on the card, on the
                          matrix as given (as before the repair: cuSOLVER)
  card_eigh_f32_sym       the same on the symmetrised matrix (small_eigh's
                          input, eigh in f32)
  cpu_eigh_f32            on the CPU, the eigh in f32 as given (LAPACK)
  card_dot_cpu            on the card, the Gram products (dot_mm) on the CPU
  cpu_eigh_card           on the CPU, small_eigh on the card

and prints the best residual and the history of each. Then op by op: every
small_eigh input (f32) and the first 40 Gram operand pairs of the card run,
recomputed on the card and on the CPU against f64 (eigenvalue error and
eigen-residual ||A V - V diag(w)|| relative to the largest |eigenvalue| and
||A||; "eigh" the f32 eigh, "small_eigh" the f64 one rounded to f32; Gram
error relative to |A|^T |B|), and the host time of one call of each eigh
at each size (median of 20, synchronised: the cost of the repair).

    python -m maxwell_tpu_torch.bench.f32_floor [--kernel ref|union|pallas]
        [--out PATH]

Needs a CUDA device (--card cpu rehearses the control flow on the CPU).
Writes JSON to --out (default build/maxwell_tpu_torch/probes/
f32_floor_<kernel>.json).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import statistics
import time

import numpy as np
import torch

from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, device_of, write

IMPL = {"ref": "ppermute", "union": "rdma_overlap", "pallas": "rdma"}
# name: (dense side, applies side, eigh on, Gram products on)
RUNS = {
    "card": ("card", "card", None, None),
    "cpu": ("cpu", "cpu", None, None),
    "dense_cpu_applies_card": ("cpu", "card", None, None),
    "dense_card_applies_cpu": ("card", "cpu", None, None),
    "card_eigh_cpu": ("card", "card", "cpu", None),
    "card_eigh_f32": ("card", "card", "f32", None),
    "card_eigh_f32_sym": ("card", "card", "f32_sym", None),
    "cpu_eigh_f32": ("cpu", "cpu", "f32", None),
    "card_dot_cpu": ("card", "card", None, "cpu"),
    "cpu_eigh_card": ("cpu", "cpu", "card", None),
}
# the runs whose arithmetic differs from the default's (f32 eigh)
F32_EIGH = ("card_eigh_f32", "card_eigh_f32_sym", "cpu_eigh_f32")


class _Split:
    """A pencil whose dense algebra runs on `host`'s device and whose
    applies run on `op`'s; Gram products on `dot`'s, where given."""

    def __init__(self, host, op, dot=None):
        self.host, self.op, self.dot = host, op, dot

    def __getattr__(self, name):
        return getattr(self.host, name)

    def _apply(self, fn, X):
        out = fn(X.to(self.op.device))
        if isinstance(out, tuple):
            return tuple(o.to(X.device) for o in out)
        return out.to(X.device)

    def K_mm(self, X):
        return self._apply(self.op.K_mm, X)

    def M_mm(self, X):
        return self._apply(self.op.M_mm, X)

    def KM_mm(self, X):
        return self._apply(self.op.KM_mm, X)

    def project(self, X):
        return self._apply(self.op.project, X)

    def dot_mm(self, A, B):
        p = self.dot or self.host
        return p.dot_mm(A.to(p.device), B.to(p.device)).to(A.device)


def _lobpcg_module():
    """solvers/lobpcg.py (the package exports a function of that name)."""
    return importlib.import_module("maxwell_tpu_torch.solvers.lobpcg")


def _f32_eigh(A):
    """The eigh as it ran before the repair: in A's dtype, on A's device,
    on the matrix as given (SVQB's scaled Gram matrix is symmetric only to
    rounding; eigh reads its lower triangle)."""
    return torch.linalg.eigh(A)


@contextlib.contextmanager
def _eigh_on(where, devices):
    """LOBPCG's small eigh (rr.small_eigh, at its three sites) replaced:
    computed by small_eigh on `where` ("cpu", "card"), or in f32 on the
    matrix as given ("f32") or symmetrised ("f32_sym"); None leaves it as
    it is."""
    from maxwell_tpu_torch.solvers import rr

    lobpcg = _lobpcg_module()
    if where is None:
        yield
        return
    small = rr.small_eigh

    def eigh(A):
        if where == "f32":
            return _f32_eigh(A)
        if where == "f32_sym":
            return _f32_eigh(0.5 * (A + A.T))
        w, V = small(A.to(devices[where]))
        return w.to(A.device), V.to(A.device)

    rr.small_eigh = lobpcg.small_eigh = eigh
    try:
        yield
    finally:
        rr.small_eigh = lobpcg.small_eigh = small


def _solve(pencils, devices, dense, op, eigh_on=None, dot_on=None):
    from maxwell_tpu_torch.solvers.dist_solve import _stacked
    from maxwell_tpu_torch.solvers.lobpcg import lobpcg_run
    from maxwell_tpu_torch.solvers.precond import shifted_cg_preconditioner
    from maxwell_tpu_torch.utils.precision import solver_precision

    pencil = _Split(pencils[dense], pencils[op],
                    pencils[dot_on] if dot_on else None)
    pc_op = shifted_cg_preconditioner(pencils[op], 10.0, 20)

    def pc(R):
        return pc_op(R.to(devices[op])).to(R.device)

    X0 = np.random.default_rng(7).standard_normal((pencils[dense].n, 7))
    with solver_precision(), _eigh_on(eigh_on, devices):
        X = pencil.project(_stacked(pencils[dense], X0, 7))
        hist = lobpcg_run(pencil, X, 60, 1e-5, pc, nev=3, stall_window=8,
                          lock_tol=1e-7, shards=range(8))[4]
    return hist


def _op_errors(pencils, devices):
    """The card run's small_eigh inputs and Gram operands, recomputed on
    each side against f64: the f32 eigh ("eigh") and small_eigh."""
    from maxwell_tpu_torch.solvers import rr
    from maxwell_tpu_torch.utils.precision import solver_precision

    lobpcg = _lobpcg_module()
    eighs, dots = [], []
    card = pencils["card"]
    cls = type(card)
    dot_mm = cls.dot_mm
    small = rr.small_eigh

    def rec_eigh(A):
        eighs.append(A.detach().clone())
        return small(A)

    def rec_dot(self, A, B):
        if len(dots) < 40:
            dots.append((A.detach().clone(), B.detach().clone()))
        return dot_mm(self, A, B)

    cls.dot_mm = rec_dot
    rr.small_eigh = lobpcg.small_eigh = rec_eigh
    try:
        _solve(pencils, devices, "card", "card")
    finally:
        rr.small_eigh = lobpcg.small_eigh = small
        cls.dot_mm = dot_mm

    kinds = {"eigh": _f32_eigh, "small_eigh": small}
    out = {kind: {s: {"w_err": 0.0, "resid": 0.0} for s in devices}
           for kind in kinds}
    out.update(gram={s: 0.0 for s in devices}, eigh_count=len(eighs),
               gram_count=len(dots))
    with solver_precision():
        for A in eighs:
            A64 = A.double().cpu()
            A64 = 0.5 * (A64 + A64.T)
            w64 = torch.linalg.eigvalsh(A64)
            scale = float(w64.abs().max())
            for side, dev in devices.items():
                for kind, fn in kinds.items():
                    w, V = (t.double().cpu() for t in fn(A.to(dev)))
                    e = out[kind][side]
                    e["w_err"] = max(e["w_err"],
                                     float((w - w64).abs().max()) / scale)
                    e["resid"] = max(e["resid"], float(
                        torch.linalg.norm(A64 @ V - V * w[None, :])
                        / torch.linalg.norm(A64)))
        out["eigh_ms"] = {side: {
            f"{kind}_{A.shape[0]}": _host_ms(lambda: fn(A.to(dev)), dev)
            for A in {e.shape[0]: e for e in eighs}.values()
            for kind, fn in kinds.items()} for side, dev in devices.items()}
        for A, B in dots:
            A64, B64 = A.double().cpu(), B.double().cpu()
            den = float((A64.abs().T @ B64.abs()).max())
            for side, dev in devices.items():
                C = pencils[side].dot_mm(A.to(dev), B.to(dev)).double().cpu()
                out["gram"][side] = max(out["gram"][side], float(
                    (C - A64.T @ B64).abs().max()) / den)
    return out


def _host_ms(fn, device, n: int = 20) -> float:
    """Median host milliseconds of fn() with the device synchronised."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    fn()
    sync()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def run(kernel: str = "ref", card="cuda") -> dict:
    from maxwell_tpu_torch.dist import partition_problem
    from maxwell_tpu_torch.problems import RectCavity2D

    devices = {"card": device_of(card), "cpu": torch.device("cpu")}
    cav = RectCavity2D(nx=16, ny=16)
    pencils = {side: partition_problem(cav, 8, kernel=kernel,
                                       dtype=torch.float32,
                                       halo_impl=IMPL[kernel], device=dev)
               for side, dev in devices.items()}
    results = {"kernel": kernel, "card": str(devices["card"]),
               "device": (torch.cuda.get_device_name(devices["card"])
                          if devices["card"].type == "cuda" else "cpu")}
    for name, (dense, op, eigh_on, dot_on) in RUNS.items():
        hist = _solve(pencils, devices, dense, op, eigh_on, dot_on)
        results[name] = {"best": min(hist), "iterations": len(hist),
                         "history": hist}
        print(json.dumps({"run": name, "best": min(hist),
                          "iterations": len(hist)}), flush=True)
    results["ops"] = _op_errors(pencils, devices)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="ref", choices=tuple(IMPL))
    ap.add_argument("--card", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    results = run(args.kernel, args.card)
    write(results, args.out or PROBE_DIR / f"f32_floor_{args.kernel}.json")
    print(json.dumps({k: v for k, v in results.items()
                      if not isinstance(v, dict) or k == "ops"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
