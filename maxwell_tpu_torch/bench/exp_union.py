"""K15a on the card: the synthetic tile-union SpMM probe of
maxwell_tpu/bench/exp_union.py. Per 128-row tile, gather the union of its
block columns once into one (K, 8) panel and run one (128, K) @ (K, 8)
product against dense values, with no layout fill: how close the panel
design comes to the copy bandwidth when every value is live.

  u0_hi    UC single block columns per tile, true f32 products
  u0_def   the same with bf16 operands and f32 sums (the TPU's DEFAULT)
  u1_runs  the panel gathered as UC / 8 runs of 8 block columns
  u2_km    u1's gather feeding two value streams (K and M): Y = Yk + Ym

    python -m maxwell_tpu_torch.bench.exp_union [T] [UC] [--device cuda|cpu]
        [--out PATH]

T tiles (default 298) and UC block columns per tile (default 128, so
K = 1024), b = m = 8; the inputs are the reference's, drawn from
numpy's default_rng(0) in its order. Per variant: time_s, per_tile_ns and
pct_roof (the reference's byte counts, exp_union.py:52-53, over the copy
bandwidth measured in the same run), the bound at the card's published
rates, the max error against the plain version (the run fails above 1e-5
of max|plain|), the plain version's time, the kernel's launch shape
(`launch`: grid, warps a block, shared memory, resident blocks per SM),
and library_ms of one torch.bmm on the panel gathered beforehand
(`library` says what it includes and excludes; u0_def's on the f32
operands the kernel reads, TF32 allowed for that call, and beside it
library_bf16_ms, the call on operands rounded to bf16 beforehand,
`library_bf16`). Every library call is held to the plain version too
(1e-5 of max|plain|; TF32 or a bf16 output 1e-2), on the CPU as well.
Runs on the card unless --device cpu is given; there the plain versions
run and nothing is timed. Writes JSON to --out (default
build/maxwell_tpu_torch/probes/exp_union_results.json).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from maxwell_tpu_torch.bench.timing import (
    bound_ms,
    copy_bandwidth,
    median_ms,
    with_tf32,
)
from maxwell_tpu_torch.kernels import union_probes as up
from maxwell_tpu_torch.utils.precision import fp32_true

PROBE_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "maxwell_tpu_torch" / "probes")
TOL = 1e-5  # of max|plain|: f32 sums in another order than the bmm's
# a library call in TF32 (10-bit mantissas) or with a bf16 output (8 bits:
# 2^-9 relative per entry) against a plain version of bf16 operands: held
# at 1e-2 of max|plain|
LIB_TOL_BF16 = 1e-2
B = M = 8
# name: (index key, run, value streams, bf16)
VARIANTS = {
    "u0_hi": ("cols", 8, 1, False),
    "u0_def": ("cols", 8, 1, True),
    "u1_runs": ("rcols", 64, 1, False),
    "u2_km": ("rcols", 64, 2, False),
}


def make_inputs(T: int, UC: int, seed: int = 0) -> dict:
    """The reference's inputs (exp_union.py:37-48), drawn in its order."""
    nbr = T * 16
    n = nbr * B
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, nbr, size=(T, UC), dtype=np.int32)
    rcols = rng.integers(0, nbr - 8, size=(T, UC // 8), dtype=np.int32)
    X = rng.standard_normal((n + 8 * B, M)).astype(np.float32)
    vals = rng.standard_normal((T * 128, UC * B)).astype(np.float32)
    vals_b = rng.standard_normal((T * 128, UC * B)).astype(np.float32)
    return dict(cols=cols, rcols=rcols, X=X, vals=vals, vals_b=vals_b, n=n)


def _rows(out, X):
    """(T, 128, 8) tile products -> Y with X's rows, those from 128 T on
    zero, as the plain version lays it out."""
    Y = torch.zeros_like(X)
    Y[: out.shape[0] * 128] = out.reshape(-1, M)
    return Y


def library(name, t, T, K):
    """(what, call, as_plain, tol) of one PyTorch call computing the
    variant's function: the call runs on operands formed beforehand (the
    panel gathered by index); as_plain maps its output onto the plain
    version's (untimed); tol is the bound against the plain version, of
    max|plain|."""
    key, run_len, streams, bf16 = VARIANTS[name]
    X, V = t["X"], t["vals"].view(T, 128, K)
    P = X[up.panel_rows(t[key], run_len)]  # (T, K, 8)
    if streams == 2:  # both streams in one call: (T, 256, 8)
        Vl = torch.cat([V, t["vals_b"].view(T, 128, K)], dim=1)
        return ("torch.bmm of the K and M values stacked (T, 256, K) on "
                "the panel gathered beforehand (excludes the gather; Yk + "
                "Ym summed after, untimed)", lambda: torch.bmm(Vl, P),
                lambda out: _rows(out[:, :128] + out[:, 128:], X), TOL)
    if bf16:
        return ("torch.bmm on the f32 values and the f32 panel gathered "
                "beforehand, TF32 allowed for this call (reads the "
                "kernel's bytes; excludes the gather)",
                with_tf32(lambda: torch.bmm(V, P)), lambda out: _rows(out, X),
                LIB_TOL_BF16)
    return ("torch.bmm on the panel gathered beforehand (excludes the "
            "gather)", lambda: torch.bmm(V, P), lambda out: _rows(out, X),
            TOL)


def library_bf16(t, T, K):
    """(what, call, as_plain, tol) of u0_def's second library call:
    torch.bmm on operands rounded to bf16 beforehand, which reads half the
    kernel's value bytes."""
    X = t["X"]
    Vb = t["vals"].view(T, 128, K).bfloat16()
    Pb = X[up.panel_rows(t["cols"], 8)].bfloat16()
    return ("torch.bmm of bf16 operands rounded beforehand on the panel "
            "gathered beforehand (reads half the kernel's value bytes; "
            "excludes the gather; bf16 output)", lambda: torch.bmm(Vb, Pb),
            lambda out: _rows(out.float(), X), LIB_TOL_BF16)


def held(name, got, want, tol=TOL):
    """(max|got - want|, max|want|), raising unless got has want's shape
    and lies within tol of max|want|."""
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if got.shape != want.shape or not err <= tol * scale:
        raise AssertionError(f"{name}: max error {err:.3e} > {tol} * "
                             f"{scale:.3e} against the plain version")
    return err, scale


def device_of(device) -> torch.device:
    """The device to run on; a CUDA device that is not there raises (no
    fall-back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible: the probe runs on the card (pass "
            "--device cpu for the plain versions)")
    return device


@fp32_true
def run(T: int = 298, UC: int = 128, device="cuda") -> dict:
    """Every variant at (T, UC) on `device`; raises if a kernel or a
    library call disagrees with its plain version. Returns the results as
    a dict."""
    dev = device_of(device)
    if UC % 8:
        raise ValueError(f"UC = {UC} must be a multiple of 8 (u1's runs)")
    data = make_inputs(T, UC)
    n, K = data["n"], UC * B
    t = {k: torch.from_numpy(v).to(dev) for k, v in data.items() if k != "n"}
    cols, rcols, X, vals, vals_b = (t[k] for k in
                                    ("cols", "rcols", "X", "vals", "vals_b"))
    timed = dev.type == "cuda"
    results = {
        "device": torch.cuda.get_device_name(dev) if timed else "cpu",
        "T": T, "UC": UC, "K": K, "n": n,
        # the reference's roofline bytes: values, X read and Y written
        "roof1_bytes": vals.numel() * 4 + 2 * n * M * 4,
        "roof2_bytes": 2 * vals.numel() * 4 + 3 * n * M * 4,
    }
    if timed:
        bw = copy_bandwidth(dev)
        results.update(bw_GBps=bw / 1e9,
                       roof1_s=results["roof1_bytes"] / bw,
                       roof2_s=results["roof2_bytes"] / bw)

    kernels = {
        "u0_hi": lambda: up.u0_hi(cols, vals, X),
        "u0_def": lambda: up.u0_def(cols, vals, X),
        "u1_runs": lambda: up.u1_runs(rcols, vals, X),
        "u2_km": lambda: up.u2_km(rcols, vals, vals_b, X),
    }
    for name, kern in kernels.items():
        key, run_len, streams, bf16 = VARIANTS[name]
        idx = t[key]
        vb = vals_b if streams == 2 else None

        def plain(idx=idx, run_len=run_len, bf16=bf16, vb=vb):
            return up.panel_plain(idx, vals, X, run_len, bf16=bf16, vals_b=vb)

        want = plain()
        err, scale = held(name, kern(), want)
        row = {"max_abs_err": err, "rel_err": err / scale}
        what, call, as_plain, tol = library(name, t, T, K)
        row.update(library=what, library_max_abs_err=held(
            f"{name} library", as_plain(call()), want, tol)[0])
        call2 = None
        if bf16:
            what2, call2, as_plain2, tol2 = library_bf16(t, T, K)
            row.update(library_bf16=what2, library_bf16_max_abs_err=held(
                f"{name} library_bf16", as_plain2(call2()), want, tol2)[0])
        if timed:
            ms = median_ms(kern)
            roof = results["roof2_s" if vb is not None else "roof1_s"]
            nbytes = (streams * vals.numel() * 4 + idx.numel() * 4
                      + 2 * X.numel() * 4)
            b_ms, b_by = bound_ms(nbytes, 2 * streams * vals.numel() * M,
                                  "bf16" if bf16 else "f32")
            row.update(
                time_s=ms * 1e-3, per_tile_ns=ms * 1e6 / T,
                pct_roof=100 * roof / (ms * 1e-3), ms=ms,
                plain_ms=median_ms(plain), bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, library_ms=median_ms(call),
                launch=up.panel_launch_shape(
                    T, K, "bf16" if bf16 else
                    "f32_fused" if vb is not None else "f32"))
            if call2 is not None:
                row["library_bf16_ms"] = median_ms(call2)
        del call, call2
        results[name] = row
    return results


def write(results: dict, out) -> Path:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("T", nargs="?", type=int, default=298)
    ap.add_argument("UC", nargs="?", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(PROBE_DIR / "exp_union_results.json"))
    args = ap.parse_args(argv)
    results = run(args.T, args.UC, args.device)
    write(results, args.out)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
