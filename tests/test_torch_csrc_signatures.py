"""The ctypes argument types the loader declares for each C entry point
(maxwell_tpu_torch/kernels/_build.py `_SIGNATURES`) against the entry
points' own declarations in maxwell_tpu_torch/csrc/*.cu: the same count, a
pointer where the C side takes a pointer and a 64-bit integer where it
takes an int64_t. ctypes passes arguments past the declared ones by its
default conversion (a 32-bit int), which cuts a pointer, so a missing
type shows only as a fault on the card; this holds the table to the
sources on the CPU."""

import ctypes
import re
from pathlib import Path

import pytest

from maxwell_tpu_torch.kernels import _build

ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def _declared():
    out = {}
    for src in sorted(_build.SRC_DIR.glob("*.cu")):
        for name, params in ENTRY.findall(src.read_text()):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                if "*" in p:
                    kinds.append(ctypes.c_void_p)
                elif p.startswith("int64_t"):
                    kinds.append(ctypes.c_int64)
                else:
                    raise AssertionError(f"{name}: parameter {p!r}")
            out[name] = kinds
    return out


DECLARED = _declared()


def test_every_entry_point_is_declared():
    assert set(DECLARED) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_the_source(name):
    assert _build._SIGNATURES[name] == DECLARED[name]
