"""The examples' shared command line: --device, and the run's printout."""

from __future__ import annotations

import argparse


def parse_device(argv, doc: str) -> str:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv).device


def show(out: dict) -> None:
    for k, v in out.items():
        print(f"{k}: {v}")
