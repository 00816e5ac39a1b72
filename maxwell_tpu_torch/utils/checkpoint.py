"""Checkpoint / resume for Krylov block solvers (SURVEY.md §5.4).

LOBPCG restarts cleanly from its current Ritz block: persisting
(X, theta, iteration) is enough — on resume the solver re-projects and
re-orthonormalizes X0, so the file format is a plain .npz written
atomically (write temp + rename). Doubles as elastic recovery
(SURVEY.md §5.3): a killed job restarts from the last block.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def save_state(path: str, *, X, theta, iteration: int, meta: dict | None = None):
    """Atomically persist solver state."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    # NB: np.savez appends ".npz" unless the name already ends with it
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(
            tmp,
            X=np.asarray(X),
            theta=np.asarray(theta),
            iteration=np.asarray(iteration),
            **{f"meta_{k}": np.asarray(v) for k, v in (meta or {}).items()},
        )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str):
    """Load solver state; returns dict or None if absent."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {
            "X": z["X"],
            "theta": z["theta"],
            "iteration": int(z["iteration"]),
        }


def load_sharded_state(path: str, D: int):
    """Reassemble in-loop per-shard snapshots `{path}.shard{d}` written by
    the distributed LOBPCG loop. Returns {"X": (D*n_loc_pad, m) stacked
    local layout, "iteration"} or None if any shard file is missing.
    NOT shard-count portable (use the exit-time file for that) — this is
    the kill-mid-solve recovery path (SURVEY.md §5.3/§5.4)."""
    shards = []
    iteration = None
    for d in range(D):
        s = load_state(f"{path}.shard{d}")
        if s is None:
            return None
        shards.append(s["X"])
        # shards may be a step apart if the kill landed mid-save; resume
        # from the OLDEST complete iteration
        it = s["iteration"]
        iteration = it if iteration is None else min(iteration, it)
    return {"X": np.concatenate(shards, axis=0), "iteration": iteration}
