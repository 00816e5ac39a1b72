"""Closed-form cavity eigenvalues — the validation oracle for configs 1 and 4
(SURVEY.md §4; BASELINE.json configs "eigenvalues vs analytic").
"""

from __future__ import annotations

import numpy as np


def te_eigenvalues_2d(a: float, b: float, count: int, max_mode: int = 64) -> np.ndarray:
    """Nonzero eigenvalues of the 2D curl-curl operator on [0,a]x[0,b] with PEC
    walls, ascending.

    The in-plane curl-curl eigenproblem reduces (on the divergence-free
    complement) to the Neumann Laplacian on the stream function, so the nonzero
    spectrum is ``pi^2 (m^2/a^2 + n^2/b^2)`` for integers m,n >= 0 not both
    zero. These are the 2D TE cavity modes of BASELINE.json config 1.
    """
    vals = []
    for m in range(0, max_mode + 1):
        for n in range(0, max_mode + 1):
            if m == 0 and n == 0:
                continue
            vals.append((np.pi * m / a) ** 2 + (np.pi * n / b) ** 2)
    vals = np.sort(np.asarray(vals))
    if count > len(vals):
        raise ValueError("increase max_mode")
    return vals[:count]


def cavity_eigenvalues_3d(
    a: float, b: float, c: float, count: int, max_mode: int = 24
) -> np.ndarray:
    """Nonzero resonant eigenvalues k^2 of a 3D PEC box cavity [0,a]x[0,b]x[0,c],
    ascending, with multiplicity.

    Modes k^2 = pi^2 (l^2/a^2 + m^2/b^2 + n^2/c^2). TE_lmn requires at most one
    of (l,m,n) zero and specific nonzero pairs; counting both TE and TM families
    the multiplicity of (l,m,n) is 1 if exactly one index is zero, and 2 if all
    three are nonzero (TE+TM degenerate). Triples with two or more zero indices
    support no resonant mode. This is the oracle for BASELINE.json config 4.
    """
    vals = []
    for l in range(0, max_mode + 1):
        for m in range(0, max_mode + 1):
            for n in range(0, max_mode + 1):
                nz = (l > 0) + (m > 0) + (n > 0)
                if nz < 2:
                    continue
                k2 = (np.pi * l / a) ** 2 + (np.pi * m / b) ** 2 + (np.pi * n / c) ** 2
                mult = 2 if nz == 3 else 1
                vals.extend([k2] * mult)
    vals = np.sort(np.asarray(vals))
    if count > len(vals):
        raise ValueError("increase max_mode")
    return vals[:count]
