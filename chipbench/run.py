#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
run of one cell.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything a cell is comes from ``BENCHMARK.json`` at the repository root
and from files found by name: the configuration's file, the traffic mix
``chipbench/traffic/<traffic>.json``, the cell's limits
``chipbench/limits/<cell>.json``, the code of its configuration's kind
``chipbench/kinds/<kind>.py`` and each per-layer metric's reader
``chipbench/metrics/<metric>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace
1`` a ``breakdown``, and last ``checks``: each number compared, with its
limit (also the last lines of standard error).  The run exits non-zero
and prints no result without enough CUDA devices, or if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def applies(entry: dict, cell: str) -> bool:
    """Whether a metric entry is reported by ``cell``."""
    return "workloads" not in entry or cell in entry["workloads"]


def cell_inputs(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry and every file it names, loaded from the
    checkout at ``root``."""
    cell = by_name(spec["workloads"], workload, "workload")
    conf = by_name(spec["configs"], cell["config"], "config")
    bench = root / "chipbench"
    return {"cell": cell, "config": load_json(root / conf["file"]),
            "traffic": load_json(bench / "traffic" /
                                 f"{cell['traffic']}.json"),
            "limits": load_json(bench / "limits" / f"{workload}.json")}


def load_file(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def read_per_layer(spec: dict, cell: str, ctx) -> dict:
    """Each per-layer metric of ``cell`` its reader finds something for:
    ``{name: {"value", "unit"}}``."""
    out = {}
    for i, m in enumerate(spec["per_layer"]):
        if not applies(m, cell):
            continue
        reader = load_file(BENCH / "metrics" / f"{m['name']}.py",
                           f"chipbench_metric_{i}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return smi.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_json(ROOT / "BENCHMARK.json")
    inputs = cell_inputs(spec, args.workload)
    cell = inputs["cell"]
    # caches the run may fill stay inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "chipbench" /
                                         "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "chipbench" /
                                             "torch_extensions")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chipbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    kind = importlib.import_module(
        f"chipbench.kinds.{inputs['config']['kind']}")
    seed = args.seed % (1 << 63)
    out = kind.run(cell, inputs["config"], inputs["traffic"],
                   inputs["limits"], seed, args.seconds, bool(args.trace),
                   "cuda:0", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"chipbench: the process holds {bad} after the window",
              file=sys.stderr)
        return 2

    if args.trace:
        metrics = read_per_layer(spec, args.workload, out["context"])
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"] if applies(m, args.workload)}
    device = {"platform": "gpu", "kind": out["device_name"],
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = out["trace"].busy_s
        device["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown()
    result["checks"] = out["checks"]
    print(f"chipbench: {args.workload} seed {args.seed} on {power_limit()}"
          f"; {out['jobs']} jobs, {out['attempted']} steps; set-up seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["setup_phases"].items()),
          file=sys.stderr)
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
