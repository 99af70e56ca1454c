#!/usr/bin/env python3
"""Where a benchmark cell's traced window goes, by the program's spans.

    python3 scripts/trace_cell_spans.py --workload arxiv-q4-p2p-varco \\
        --seed 7 --seconds 45                  # on an H100

Runs one cell of ``BENCHMARK.json`` as ``chipbench/run.py --trace 1``
does (the cell's set-up, the warm-up job, a traced window of whole jobs)
and prints one JSON line: the cell's per-layer metrics; the window's
seconds, steps and device busy seconds; every ``repro_torch.`` span's
host seconds and count in the window (``spans``); the idle stretches of
the device named by the innermost program span at their middle, however
long that span is (``idle_by_span``); the ``cudaStreamSynchronize``
calls inside ``train.step`` that lie in no ``sync.*`` span
(``uncovered_syncs``); the device-row events named like a program span
(``mirrored``: a span the profiler copied onto the device's row, which
the harness would count as device work; 0 expected); and the run's
``correct``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chipbench import program_spans as ps  # noqa: E402
from chipbench import run as bench  # noqa: E402
from chipbench.kinds import gnn_train  # noqa: E402


def idle_by_span(trace) -> dict:
    """Idle seconds of the window by the innermost program span at each
    gap's middle (gaps under 20 us summed apart)."""
    found = sorted((a, b, name) for name, iv in ps._by_name(trace).items()
                   for a, b in iv)
    out: dict = collections.defaultdict(float)
    stack: list = []
    i = 0
    for a, b in trace.gaps():
        if b - a < 20_000:
            out["gaps under 20 us"] += (b - a) * 1e-9
            continue
        mid = (a + b) // 2
        while i < len(found) and found[i][0] <= mid:
            while stack and stack[-1][1] <= found[i][0]:
                stack.pop()
            stack.append(found[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        out[stack[-1][2] if stack else "outside every span"] += \
            (b - a) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _innermost(found: list, starts: list, a: int, b: int):
    """The shortest of ``found``'s spans (sorted by start) holding ``[a,
    b)``, looking back 64 spans; ``None`` if there is none."""
    j = bisect.bisect_right(starts, a)
    around = [f for f in found[max(j - 64, 0):j] if b <= f[1]]
    return min(around, key=lambda f: f[1] - f[0]) if around else None


def uncovered_syncs(trace) -> dict:
    """Stream syncs inside the steps that no ``sync.*`` span holds,
    counted by the innermost program span around them."""
    starts, ends, names = trace.ops
    syncs = sorted((a, b) for a, b, n in zip(starts, ends, names)
                   if n == "cudaStreamSynchronize")
    steps = ps.spans(trace, ps.named("train.step"))
    covered = [(a, b, "sync") for a, b in ps.spans(trace, ps.is_sync)]
    found = sorted((a, b, name) for name, iv in ps._by_name(trace).items()
                   for a, b in iv)
    cover_starts = [f[0] for f in covered]
    found_starts = [f[0] for f in found]
    out: collections.Counter = collections.Counter()
    for inside in ps.within(steps, syncs):
        for a, b in inside:
            if _innermost(covered, cover_starts, a, b) is None:
                span = _innermost(found, found_starts, a, b)
                out[span[2] if span else "no span"] += 1
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    spec = bench.load_json(ROOT / "BENCHMARK.json")
    inputs = bench.cell_inputs(spec, args.workload)
    out = gnn_train.run(inputs["cell"], inputs["config"], inputs["traffic"],
                        inputs["limits"], args.seed % (1 << 63),
                        args.seconds, True, "cuda:0", T_START)
    tr, ctx = out["trace"], out["context"]
    spans = {name: [sum(min(b, tr.t1) - max(a, tr.t0) for a, b in iv
                        if b > tr.t0 and a < tr.t1) * 1e-9, len(iv)]
             for name, iv in sorted(ps._by_name(tr).items())}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "card": out["device_name"], "power": bench.power_limit(),
        "window_s": tr.window_s, "busy_s": tr.busy_s, "steps": ctx.steps,
        "jobs": out["jobs"], "correct": out["correct"],
        "per_layer": {k: v["value"] for k, v in
                      bench.read_per_layer(spec, args.workload,
                                           ctx).items()},
        "spans": spans, "idle_by_span": idle_by_span(tr),
        "uncovered_syncs": uncovered_syncs(tr),
        "mirrored": sum(n.startswith(ps.PREFIX) for n in tr.dev_names),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
