#!/usr/bin/env python3
"""The readings the limits of ``chipbench/limits/<cell>.json`` are set
from, at the cell's own size, on the card.

    python3 chipbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--faults 3]

The cell's set-up once (the configuration's graph and the program's
partition of it), then for each seed: the weights from the seed, one job
through the window's own ``job`` call and wrappers, stopped after the
steps ``reference.steps_compared`` names, then the numbers compared
(``reference.gaps``) for these readings against the float32 reference:

* ``program``: the program's steps (the lower readings);
* ``control``: the reference itself computed with TF32 matrix products;
* ``reordered``: the reference again with its edge lists in another
  order, a second float32 witness: how far rounding alone carries a job
  by the full-rate steps;
* on the first ``--faults`` seeds, faults planted in the reference put
  in the program's place: ``half_batch`` (half the training nodes left
  out, the mean over the rest), ``no_exchange`` (the halo exchange left
  out), ``remote_fifth`` (every fifth remote edge left out) and
  ``frozen`` (a step that returns its state unchanged).

One JSON line a seed, with each reading's relative loss gap at every
step followed (``loss_by_step``).  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

DEVICE = "cuda:0"


def leaves(prog: dict, ref: dict, params0, plan: dict) -> dict:
    """:func:`reference.leaf_gaps` as lists, after the early steps and
    after the full-rate ones, with each leaf's size."""
    from chipbench import reference

    out = {"numel": [int(t.numel()) for t in reference.leaves(params0)]}
    for tag, after in (("early", len(plan["early"])),
                       ("full_rate", plan["follow"])):
        per = reference.leaf_gaps(prog, ref, params0, after)
        out[tag] = {k: v.tolist() for k, v in per.items()}
    return out


def main() -> int:
    import numpy as np
    import torch

    from chipbench import reference
    from chipbench import run as bench
    from chipbench.kinds import gnn_train as kind

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args()
    spec = bench.load_json(ROOT / "BENCHMARK.json")
    inputs = bench.cell_inputs(spec, args.workload)
    cfg, traffic = inputs["config"], inputs["traffic"]
    recipe = cfg["recipe"]
    plan = reference.steps_compared(traffic)
    graph, pg, _, dims = kind.setup(cfg, args.seeds[0], DEVICE, {})
    owner = np.asarray(pg.owner)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        params0 = kind.make_weights(dims, seed, DEVICE)
        rec = kind.Recorder(traffic, False)
        rec.install()
        try:
            kind.job(pg, cfg, traffic, rec, params0, seed, DEVICE,
                     traffic["job_epochs"], stop_after=plan["follow"] + 1)
        finally:
            rec.uninstall()
        prog = kind.program_readings(rec.jobs[-1], traffic)
        torch.cuda.empty_cache()
        t_prog = time.perf_counter() - t0

        def follow(g=graph, tf32=False):
            return reference.run(g, owner, params0, traffic, recipe, DEVICE,
                                 tf32=tf32)

        def planted(drop):
            """The reference with its aggregation wrapped by ``drop``."""
            orig = reference._aggregate
            reference._aggregate = drop(orig)
            try:
                return follow()
            finally:
                reference._aggregate = orig

        def reordered(orig):
            def agg(lay, x, mask, mix):
                moved = copy.copy(lay)
                for group in (("loc_dst", "loc_src", "loc_w", "loc_w_iso"),
                              ("rem_dst", "rem_src", "rem_w")):
                    n = len(getattr(lay, group[0]))
                    order = torch.randperm(n, generator=torch.Generator()
                                           .manual_seed(n)).to(x.device)
                    for name in group:
                        setattr(moved, name, getattr(lay, name)[order])
                return orig(moved, x, mask, mix)
            return agg

        ref = follow()
        readings = {"program": prog, "control": follow(tf32=True),
                    "reordered": planted(reordered)}
        out = {"workload": args.workload, "seed": seed,
               **{k: reference.gaps(r, ref, params0, plan)
                  for k, r in readings.items()},
               "loss_by_step": {k: [abs(a - b) / abs(b) for a, b in
                                    zip(r["loss"], ref["loss"])]
                                for k, r in readings.items()},
               "leaves": {k: leaves(readings[k], ref, params0, plan)
                          for k in ("program", "control")}}
        if i < args.faults:
            half = dict(graph)
            train = np.flatnonzero(graph["train_mask"])
            half["train_mask"] = graph["train_mask"].copy()
            half["train_mask"][train[len(train) // 2:]] = False

            def no_exchange(orig):
                return lambda lay, x, mask, mix: orig(
                    lay, x, torch.zeros_like(x), mix)

            def remote_fifth(orig):
                def agg(lay, x, mask, mix):
                    keep = torch.arange(len(lay.rem_dst),
                                        device=x.device) % 5 != 0
                    cut = copy.copy(lay)
                    for name in ("rem_dst", "rem_src", "rem_w"):
                        setattr(cut, name, getattr(lay, name)[keep])
                    return orig(cut, x, mask, mix)
                return agg

            frozen = {"loss": [ref["loss"][0]] * plan["follow"],
                      "grad0": ref["grad0"],
                      "params": {k: reference.leaves(params0)
                                 for k in ref["params"]}}
            out["faults"] = {
                "half_batch": reference.gaps(follow(half), ref, params0,
                                             plan),
                "no_exchange": reference.gaps(planted(no_exchange), ref,
                                              params0, plan),
                "remote_fifth": reference.gaps(planted(remote_fifth), ref,
                                               params0, plan),
                "frozen": reference.gaps(frozen, ref, params0, plan)}
        out["seconds"] = {"program": t_prog,
                          "checks": time.perf_counter() - t0 - t_prog}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
