"""Where level_solve's time goes, on the card: the kernel of
csrc/tri_solve.cu against an earlier build of it (`--parent`), in turns in
one process, on the factors the smoke's phase 24 holds it to:

  the 128^2 rectangle's LDL^T L and L^T at sigma 45 (chains of 32,512
  levels, window 256) and config 3's splu L and U (16x16, 147 and 165
  levels, windows 471 and 397), f32 and f64, m 1 and 4.

Each case times, by device_ms (median of 5 calls), the parent and the
change (`ms`) in the order parent, change, change, parent; and reports the
route (x's window in shared memory or device memory), the window, the
ring, the levels, microseconds a level, the chain floor
(`chain_floor_ms`: tri_solve.level_chain over as many positions as the
factor has levels with the solve's 16 warps, the tag hand-off floor of
this design, no loads), the same hand-off with 2 and 4 warps
(`handoff_ms`) and the byte bound as the smoke counts it. Each kernel's
solve is held to a backward error of at most 2
(tri_solve.backward_error) and the change's two runs must agree bit for
bit.

--parent DIR: an unpacked `git archive` of an earlier commit whose
csrc/tri_solve.cu has the padded-layout entry (level_solve_f32/f64 taking
rows, cnt, live, cols, vals, dinv, b, x, n_levels, R, S, m, stream); it is
built alone with nvcc into build/maxwell_tpu_torch/ and driven with the
padded layout, which LevelSchedule still carries. Without --parent only
the change is timed.

    python -m maxwell_tpu_torch.bench.profile_tri_solve [--parent DIR]
        [--out PATH]

Runs on the card only; writes JSON to --out (default
build/maxwell_tpu_torch/probes/profile_tri_solve.json).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import time
from pathlib import Path

import scipy.sparse.linalg as spla
import torch

from maxwell_tpu_torch.bench.exp_union import PROBE_DIR, write
from maxwell_tpu_torch.bench.timing import bound_ms, device_ms
from maxwell_tpu_torch.kernels import _build
from maxwell_tpu_torch.kernels import tri_solve as ts
from maxwell_tpu_torch.problems import RectCavity2D

GRID, SIGMA, WIDTHS = 128, 45.0, (1, 4)
HANDOFF_WARPS = (2, 4)  # level_chain's warps beside the solve's
_P, _I = ctypes.c_void_p, ctypes.c_int64


def load_parent(root) -> ctypes.CDLL:
    """The earlier csrc/tri_solve.cu under root, built alone."""
    src = Path(root) / "maxwell_tpu_torch" / "csrc" / "tri_solve.cu"
    text = src.read_bytes()
    out = _build.BUILD_DIR / (
        f"libtri_parent_{hashlib.sha256(text).hexdigest()[:16]}.so")
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               str(out), str(src)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        _build._check(cmd, done.returncode, done.stdout + done.stderr)
    lib = ctypes.CDLL(str(out))
    for name in ("level_solve_f32", "level_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        fn.restype = ctypes.c_int
    return lib


def parent_solve(lib, S, B):
    """X = T^-1 B by the earlier kernel, on the padded layout."""
    X = torch.empty_like(B)
    name = "level_solve_f32" if B.dtype == torch.float32 else (
        "level_solve_f64")
    rc = getattr(lib, name)(
        S.rows.data_ptr(), S.cnt.data_ptr(), S.live.data_ptr(),
        S.cols.data_ptr(), S.vals.data_ptr(), S.dinv.data_ptr(),
        B.data_ptr(), X.data_ptr(), S.n_levels, S.rows.shape[1],
        S.cols.shape[2], B.shape[1],
        torch.cuda.current_stream(B.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent {name}: CUDA error {rc}")
    return X


def factors(dev) -> dict:
    """{(problem, factor): {dtype: LevelSchedule}} on dev."""
    big = RectCavity2D(nx=GRID, ny=GRID)
    A = (big.K - SIGMA * big.M).tocsr()
    small = RectCavity2D(nx=16, ny=16)
    A3 = (small.K - SIGMA * small.M).tocsc()
    out = {}
    for dt in (torch.float64, torch.float32):
        d = ts.SparseLDLTDevice.factor(A, dtype=dt, device=dev)
        lu = ts.SparseLUDevice.from_splu(spla.splu(A3), dtype=dt, device=dev)
        for key, S in (((f"ldlt{GRID}", "L"), d.L),
                       ((f"ldlt{GRID}", "Lt"), d.Lt),
                       (("config3_splu", "L"), lu.L),
                       (("config3_splu", "U"), lu.U)):
            out.setdefault(key, {})[dt] = S
    return out


def work(S, m: int, dtype: torch.dtype) -> tuple[int, int]:
    """(bytes, operations) of one factor solve of width m in dtype, as its
    bound counts them: each live value and column once, the rows' ids and
    counts, the level counts, 1/diag, B read and X written; a multiply-add
    a live slot and a subtract and multiply a row, for each column."""
    dsz = torch.finfo(dtype).bits // 8
    live = int(S.cnt.sum())
    nbytes = (live * (4 + dsz) + S.n * 8 + S.n_levels * 4 + S.n * dsz
              + 2 * S.n * m * dsz)
    return nbytes, 2 * live * m + 2 * S.n * m


def chain_floor_ms(levels: int, dev, warps: int = ts.WARPS) -> float:
    """The tag hand-off floor for a factor of `levels` levels: device_ms
    of tri_solve.level_chain over as many positions with `warps` warps
    (the solve's by default), after one run checked to have handed its
    value through all of them."""
    out = ts.level_chain(levels, dev, warps)
    if out.item() != levels:
        raise AssertionError(f"level_chain({levels}) gave {out.item()}")
    return device_ms(lambda: ts.level_chain(levels, dev, warps), n=5)


def _held(label, S, B, X) -> None:
    err = ts.backward_error(S, B, X)
    if not err <= 2:
        raise AssertionError(f"{label}: backward error {err:.3g}")


def run(parent=None, device="cuda") -> dict:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("profile_tri_solve times kernels: it needs the "
                           "card")
    lib = load_parent(parent) if parent else None
    t0 = time.perf_counter()
    facs = factors(dev)
    rows = []
    floors, handoff = {}, {}
    shape = {f"{d}_{r}": ts.launch_shape(dt, r)
             for d, dt in (("f32", torch.float32), ("f64", torch.float64))
             for r in ("shared", "global")}
    gen = torch.Generator(device="cpu").manual_seed(0)
    for (prob, fac), by_dtype in facs.items():
        n = by_dtype[torch.float64].n
        B4 = torch.randn((n, 4), generator=gen, dtype=torch.float64).to(dev)
        for dt, S in by_dtype.items():
            dname = "f32" if dt == torch.float32 else "f64"
            if S.n_levels not in floors:
                floors[S.n_levels] = chain_floor_ms(S.n_levels, dev)
                handoff[S.n_levels] = {
                    w: chain_floor_ms(S.n_levels, dev, w)
                    for w in HANDOFF_WARPS}
            for m in WIDTHS:
                Bm = B4[:, :m].to(dt).contiguous()
                label = f"{prob} {fac} {dname} m={m}"
                got = ts.level_solve(S, Bm)
                if not torch.equal(got, ts.level_solve(S, Bm)):
                    raise AssertionError(f"{label}: two runs differ")
                _held(label, S, Bm, got)
                turns = [("ms", lambda: ts.level_solve(S, Bm))]
                if lib is not None:
                    _held(f"{label} parent", S, Bm, parent_solve(lib, S, Bm))
                    turns.insert(0, ("parent",
                                     lambda: parent_solve(lib, S, Bm)))
                times = {key: [] for key, _ in turns}
                for key, fn in turns + turns[::-1]:
                    times[key].append(device_ms(fn, n=5))
                rows.append({
                    "factor": f"{prob} {fac}", "dtype": dname, "m": m,
                    "n": n, "levels": S.n_levels, "window": S.window,
                    "route": S.route(dt), "ring": S.ring(dt),
                    "live_slots": int(S.cnt.sum()),
                    "padded_slots": S.cols.numel(), **times,
                    "us_per_level": min(times["ms"]) * 1e3 / S.n_levels,
                    "chain_floor_ms": floors[S.n_levels],
                    "handoff_ms": handoff[S.n_levels],
                    "bound_ms": bound_ms(*work(S, m, dt), dname)[0],
                })
                print(json.dumps(rows[-1]), flush=True)
    return {"device": torch.cuda.get_device_name(dev), "shape": shape,
            "seconds": time.perf_counter() - t0, "cases": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=str(PROBE_DIR / "profile_tri_solve.json"))
    args = ap.parse_args(argv)
    results = run(args.parent)
    results["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    write(results, args.out)
    print(json.dumps({k: v for k, v in results.items() if k != "cases"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
