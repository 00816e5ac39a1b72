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
of max|plain|), the plain version's time, and one torch.bmm on the panel
gathered beforehand (the library line; it excludes the gather). Runs on
the card unless --device cpu is given; there the plain versions run and
nothing is timed. Writes JSON to --out (default
build/maxwell_tpu_torch/probes/exp_union_results.json).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from maxwell_tpu_torch.bench.timing import bound_ms, copy_bandwidth, median_ms
from maxwell_tpu_torch.kernels import union_probes as up
from maxwell_tpu_torch.utils.precision import fp32_true

PROBE_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "maxwell_tpu_torch" / "probes")
TOL = 1e-5  # of max|plain|: f32 sums in another order than the bmm's
B = M = 8


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
    """Every variant at (T, UC) on `device`; raises if a kernel disagrees
    with its plain version. Returns the results as a dict."""
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

    V = vals.view(T, 128, K)
    variants = {
        # name: (kernel, index, run, value streams, bf16)
        "u0_hi": (lambda: up.u0_hi(cols, vals, X), cols, 8, (vals,), False),
        "u0_def": (lambda: up.u0_def(cols, vals, X), cols, 8, (vals,), True),
        "u1_runs": (lambda: up.u1_runs(rcols, vals, X), rcols, 64, (vals,),
                    False),
        "u2_km": (lambda: up.u2_km(rcols, vals, vals_b, X), rcols, 64,
                  (vals, vals_b), False),
    }
    for name, (kern, idx, run_len, streams, bf16) in variants.items():
        vb = streams[1] if len(streams) > 1 else None

        def plain(idx=idx, run_len=run_len, bf16=bf16, vb=vb):
            return up.panel_plain(idx, vals, X, run_len, bf16=bf16, vals_b=vb)

        got, want = kern(), plain()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if not err <= TOL * scale:
            raise AssertionError(f"{name}: max error {err:.3e} > {TOL} * "
                                 f"{scale:.3e} against the plain version")
        row = {"max_abs_err": err, "rel_err": err / scale}
        if timed:
            P = X[up.panel_rows(idx, run_len)]  # (T, K, 8), gathered once
            if bf16:
                Vl, Pl = V.bfloat16(), P.bfloat16()
            elif vb is not None:  # both streams in one call: (T, 256, 8)
                Vl, Pl = torch.cat([V, vb.view(T, 128, K)], dim=1), P
            else:
                Vl, Pl = V, P
            ms = median_ms(kern)
            roof = results["roof2_s" if vb is not None else "roof1_s"]
            nbytes = (len(streams) * vals.numel() * 4 + idx.numel() * 4
                      + 2 * X.numel() * 4)
            b_ms, b_by = bound_ms(nbytes, 2 * len(streams) * vals.numel() * M,
                                  "bf16" if bf16 else "f32")
            row.update(
                time_s=ms * 1e-3, per_tile_ns=ms * 1e6 / T,
                pct_roof=100 * roof / (ms * 1e-3), ms=ms,
                plain_ms=median_ms(plain), bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, library_ms=median_ms(lambda: torch.bmm(Vl, Pl)),
                library="torch.bmm on the panel gathered beforehand "
                        "(excludes the gather)"
                        + ("; bf16 operands" if bf16 else "")
                        + ("; K over M stacked" if vb is not None else ""))
            del P, Vl, Pl
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
