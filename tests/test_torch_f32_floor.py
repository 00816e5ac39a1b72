"""maxwell_tpu_torch/bench/f32_floor.py rehearsed on the CPU (--card cpu):
every placement runs the 8-shard 16x16 LOBPCG to the CPU's floor, the
placements that only move ops between two CPU "sides" repeat the CPU run
bit for bit, and the op-by-op pass records the eigh and Gram operands.
The two runs with the small eigh in f32 (as before the repair) differ from
the default, whose small eigh is f64."""

import json

import numpy as np
import torch

from maxwell_tpu_torch.bench import f32_floor

torch.set_num_threads(1)


def test_f32_floor_rehearsal_on_cpu(tmp_path):
    out = tmp_path / "floor.json"
    assert f32_floor.main(["--kernel", "ref", "--card", "cpu",
                           "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["device"] == "cpu" and set(f32_floor.RUNS) <= set(r)
    for name in f32_floor.RUNS:
        assert r[name]["best"] <= 1e-5, (name, r[name])
        if name not in f32_floor.F32_EIGH:  # the runs that change the math
            assert r[name]["history"] == r["cpu"]["history"]
    ops = r["ops"]
    assert ops["eigh_count"] > 0 and ops["gram_count"] > 0
    for side in ("card", "cpu"):
        assert ops["eigh"][side]["resid"] <= 1e-5
        assert ops["small_eigh"][side]["resid"] <= 1e-5
        assert ops["gram"][side] <= 1e-5
    assert set(ops["eigh_ms"]["cpu"]) == {
        f"{kind}_{n}" for kind in ("eigh", "small_eigh") for n in (7, 21)}
    assert all(t > 0 for t in ops["eigh_ms"]["cpu"].values())
    assert r["card_eigh_f32"]["history"] == r["cpu_eigh_f32"]["history"]
    assert np.isfinite(r["card_eigh_f32"]["best"])
