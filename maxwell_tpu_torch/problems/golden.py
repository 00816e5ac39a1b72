"""Golden fixtures (SURVEY.md §2 C16): in-repo reference eigenvalues for the
standard cavity test matrices — the parity oracle ("match the reference
eigenpairs ... within its residual tolerance", BASELINE.json:5).

Values were computed with the dense generalized eigh oracle (nullspace
filtered) and are regenerable via tests/unit/test_golden.py's commented
recipe.
"""

from __future__ import annotations

import json
import os

_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden.json")


def load_golden() -> dict:
    with open(_PATH) as f:
        return {k: v for k, v in json.load(f).items() if not k.startswith("_")}


def golden_eigenvalues(name: str):
    import numpy as np

    g = load_golden()[name]
    return np.asarray(g["eigenvalues"]), g["residual_tol"], g["problem"]
