"""CSV logging helpers (counterpart of ``repro/train/metrics.py``)."""

from __future__ import annotations

import csv
import os
import sys


def write_csv(path: str, rows: list[dict]) -> None:
    if not rows:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    keys = list(rows[0].keys())
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def print_csv(rows: list[dict], file=None) -> None:
    file = file or sys.stdout
    if not rows:
        return
    keys = list(rows[0].keys())
    print(",".join(keys), file=file)
    for r in rows:
        print(",".join(_fmt(r[k]) for k in keys), file=file)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)
