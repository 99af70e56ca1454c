#!/usr/bin/env python3
"""Where the GNN path's device time goes, by ``torch.profiler``.

    python3 scripts/profile_gnn_step.py                  # on an H100
    python3 scripts/profile_gnn_step.py --nodes 20000    # a smaller graph
    python3 scripts/profile_gnn_step.py --nodes 2000 --device cpu
                                          # rehearsal: CPU times only
    python3 scripts/profile_gnn_step.py --wires dense  # one wire only
    python3 scripts/profile_gnn_step.py --runs auto_w8,auto_stale
                                          # named runs only, no refresh

Builds ``chip_smoke.py``'s workload: ``citation_graph(n=169_343,
feat_dim=128)`` cut ``metis-like`` into Q = 4 partitions on one card,
and GraphSAGE at the paper's width (128 -> 256 -> 40, 3 layers) with
seeded weights, served by a ``ServingEngine``. For each training run of
the chosen wires — p2p: ``full``, ``varco:linear:5``,
``auto:budget:<half the full-rate transport>:w8``, ``auto:error:<half>:w8``
and ``auto:stale:<half>`` (``blockmask``); dense: ``full``, ``fixed:4``
and ``varco:linear:5`` (the paper's ``randmask``); packed:
``varco:linear:5`` (``blockmask``) and ``auto:budget:<half>:w4`` — it
sets up the step as ``train_gnn`` does (AdamW, the controller, the
``stale`` halo cache or the p2p error-feedback residuals), runs two
untraced steps (kernel build, allocator warm-up), then traces the
third; then, unless ``--runs`` names runs, it traces one warm
cold-start refresh of the serving engine (``refresh(force=True)`` after
an untraced one). For each traced item it prints one JSON line:
the host-clock wall time (ending in a device sync), the device time
summed over every kernel (self time), the device's idle share of the
wall time (an upper bound: the profiler's host cost inflates the wall
time), the number of kernels launched, the port's kernel launch
counters, the shares of ``ell_spmm``'s and ``random_mask``'s kernels,
the kernels with the most device time (on the p2p wire, beside
``ell_spmm``'s launches its launches over the remote ELL lists,
``ell_spmm.remote``, and the lists' degrees ``Kr``/``RKr`` and fill),
and the host milliseconds and count of each of the program's spans
(``repro_torch.spans``: the step's parts, the halo exchange, the
controller's ``ratectl.plan`` / ``ratectl.observe``, the ``sync.*``
waits).  On the card each step item also lists where a fourth step, run
under ``torch.cuda.set_sync_debug_mode("warn")``, makes the host wait for the
card (``sync_sites``: the innermost frame of the port or of this script,
with counts), to hold against the ``sync.*`` spans' counts.  The
card's name and power limit go on the first line. If the trace holds no
device time it falls back to CUDA events around the step (device time
then is not split by kernel). On the CPU the list holds operators' CPU
self times, never device numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.core.varco import CommPolicy  # noqa: E402
from repro_torch.dist.gnn_parallel import DistMeta, make_train_step  # noqa
from repro_torch.dist.halo import (attach_p2p, remote_ell,  # noqa: E402
                                   remote_ell_stats)
from repro_torch.dist.ratectl import (exchange_widths,  # noqa: E402
                                      init_halo_cache, init_wire_residuals,
                                      make_auto_train_step, make_controller)
from repro_torch.graph.synthetic import citation_graph  # noqa: E402
from repro_torch.kernels import ell_spmm as _ell  # noqa: E402
from repro_torch.kernels import ops as _ops  # noqa: E402
from repro_torch.kernels import randmask as _rm  # noqa: E402
from repro_torch.kernels import varco_pack as _vp  # noqa: E402
from repro_torch.nn.gnn import GNNConfig, init_gnn  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402
from repro_torch.spans import PREFIX, span  # noqa: E402
from repro_torch.train.optim import adamw  # noqa: E402

TOP = 15    # kernels listed per traced item
EPOCHS = 5  # the policies' schedule length, as in chip_smoke.py
COUNTERS = {"ell_spmm": _ell.ell_spmm, "varco_pack": _vp.varco_pack,
            "varco_unpack": _vp.varco_unpack,
            "varco_pack_quant": _vp.varco_pack_quant,
            "varco_unpack_quant": _vp.varco_unpack_quant,
            "random_mask": _rm.random_mask,
            "varco_pack_quant_stochastic": _vp.varco_pack_quant_stochastic,
            "random_uniform": _rm.random_uniform}
#: the data pointers of the traced run's remote ELL lists (forward and
#: reversed) and the ``ell_spmm`` launches over them
REMOTE = {"lists": set(), "launches": 0}


def _count_remote(kernel):
    """``ops.ell_spmm`` noting each launch over the remote lists: the
    remote share of ``ell_spmm.launches``."""
    def launch(x, nbr, w):
        if nbr.data_ptr() in REMOTE["lists"]:
            REMOTE["launches"] += 1
        return kernel(x, nbr, w)
    return launch


#: the traced runs of each wire: name -> (policy spec, compressor);
#: ``{half}`` is half the full-rate transport of EPOCHS steps
RUNS = {"p2p": {"full": ("full", "blockmask"),
                "varco": ("varco:linear:5", "blockmask"),
                "auto_w8": ("auto:budget:{half:g}:w8", "blockmask"),
                "auto_error_w8": ("auto:error:{half:g}:w8", "blockmask"),
                "auto_stale": ("auto:stale:{half:g}", "blockmask")},
        "dense": {"dense_full": ("full", None),
                  "dense_fixed4": ("fixed:4", None),
                  "dense_varco": ("varco:linear:5", None)},
        "packed": {"packed_varco": ("varco:linear:5", "blockmask"),
                   "packed_auto_w4": ("auto:budget:{half:g}:w4",
                                      "blockmask")}}


def _self_time_us(evt, on_card: bool) -> float:
    if on_card:
        return float(getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0)))
    return float(evt.self_cpu_time_total)


def _spans(prof) -> dict:
    """Host milliseconds (the span's own interval, children included) and
    count of every ``repro_torch.`` span of a finished profile."""
    return {e.key[len(PREFIX):]: {"host_ms": e.cpu_time_total / 1e3,
                                  "count": e.count}
            for e in prof.key_averages() if e.key.startswith(PREFIX)}


def _sync_sites(fn) -> dict:
    """Where ``fn`` makes the host wait for the card: the sites of the
    warnings of ``torch.cuda.set_sync_debug_mode("warn")``, each the
    innermost frame of the port or of this script inside ``fn``."""
    root = Path(__file__).resolve().parents[1]
    sites: collections.Counter = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if ("repro_torch" in f.filename or
                      f.filename == __file__) and f.name != "_sync_sites"]
        if not frames:
            sites["(no Python frame of the port)"] += 1
            return
        f = frames[-1]
        rel = Path(f.filename).resolve()
        rel = rel.relative_to(root) if rel.is_relative_to(root) else rel
        sites[f"{rel}:{f.lineno} {f.name}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sites)


def _trace(fn, device: torch.device) -> dict:
    """Trace one call of ``fn``: wall time, device time by kernel, idle
    share, launches (profiler count and the port's counters) and the
    program's spans."""
    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    for c in COUNTERS.values():
        c.launches = 0
    REMOTE["launches"] = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    counters = {name: c.launches for name, c in COUNTERS.items()}
    counters["ell_spmm.remote"] = REMOTE["launches"]
    # on the card: the kernels (device-side events) only, so no time is
    # counted both under a kernel and under the operator that launched it
    rows = [(e.key[:160], _self_time_us(e, on_card), e.count)
            for e in prof.key_averages()
            if not on_card or str(e.device_type).endswith("CUDA")]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    rec = {"wall_ms": wall_us / 1e3, "port_kernel_launches": counters,
           "spans": _spans(prof)}
    if on_card and not rows:
        # no device events in the trace: time the call by CUDA events
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return {**rec, "time_kind": "CUDA events around the call (the "
                "trace held no device time)",
                "device_ms": start.elapsed_time(end)}
    busy_us = sum(r[1] for r in rows)
    ell_us = sum(r[1] for r in rows if "ell_spmm" in r[0])
    mask_us = sum(r[1] for r in rows if "random_mask" in r[0])
    rec.update({
        "time_kind": "device self time" if on_card
        else "CPU self time (not a device number)",
        "device_ms": busy_us / 1e3 if on_card else None,
        "device_idle_share": 1.0 - busy_us / wall_us if on_card else None,
        "kernels_launched": sum(r[2] for r in rows) if on_card else None,
        "ell_spmm_ms": ell_us / 1e3 if on_card else None,
        "ell_spmm_share": ell_us / busy_us if on_card and busy_us else None,
        "random_mask_ms": mask_us / 1e3 if on_card else None,
        "random_mask_share": mask_us / busy_us if on_card and busy_us
        else None,
        "top": [{"op": k, "ms": us / 1e3, "calls": n}
                for k, us, n in rows[:TOP]]})
    return rec


def _step_fn(pg, cfg, params, spec: str, device, wire: str = "p2p",
             compressor: str | None = "blockmask"):
    """One training step under ``spec`` as ``train_gnn`` runs it on
    ``wire`` (AdamW): returns ``step(epoch)``, which runs the step and
    waits for its loss."""
    policy = CommPolicy.parse(spec, EPOCHS, compressor=compressor)
    graph = pg.device_arrays(device)
    REMOTE["lists"] = set()
    if wire == "p2p" or policy.mode == "auto":
        graph = attach_p2p(graph, pg, device)
    if wire == "p2p":                    # derived here, outside the trace
        REMOTE["lists"] = {remote_ell(graph)[k].data_ptr()
                           for k in ("remote_nbr", "remote_rnbr")}
    meta = DistMeta.build(pg, params, wire=wire)
    opt = adamw(5e-3)
    state = {"params": params, "opt": opt.init(params), "cache": ()}
    if policy.mode == "auto":
        ctl = make_controller(policy, meta, cfg, total_steps=EPOCHS)
        state["ctl"] = ctl.init()
        step = make_auto_train_step(cfg, policy, opt, meta)
        if policy.controller == "stale":
            state["cache"] = init_halo_cache(meta, cfg, device)
        elif policy.max_width < 32 and wire == "p2p":
            state["cache"] = init_wire_residuals(meta, cfg, device)

        def run(epoch):
            plan, state["ctl"] = ctl.plan(state["ctl"], epoch)
            state["params"], state["opt"], m, state["cache"] = step(
                state["params"], state["opt"], graph, prng.key(epoch), plan,
                state["cache"])
            state["ctl"] = ctl.observe(state["ctl"], m)
            with span("sync.loss"):
                return float(m["loss"])
    else:
        step = make_train_step(cfg, policy, opt, meta)

        def run(epoch):
            state["params"], state["opt"], m = step(
                state["params"], state["opt"], graph, epoch,
                prng.key(epoch))
            with span("sync.loss"):
                return float(m["loss"])
    run.remote_ell = remote_ell_stats(graph) if wire == "p2p" else None
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=169_343)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--wires", default="p2p,dense,packed",
                    help="comma-separated wires to trace steps on")
    ap.add_argument("--runs", default="",
                    help="comma-separated run names to trace (default: "
                    "every run of the wires, then the refresh)")
    args = ap.parse_args(argv)
    wires = [w for w in args.wires.split(",") if w]
    for w in wires:
        if w not in RUNS:
            ap.error(f"unknown wire {w!r}; have {sorted(RUNS)}")
    only = {r for r in args.runs.split(",") if r}
    known = {name for runs in RUNS.values() for name in runs}
    if only - known:
        ap.error(f"unknown runs {sorted(only - known)}; have "
                 f"{sorted(known)}")

    _ops.ell_spmm = _count_remote(_ops.ell_spmm)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
            else "nvidia-smi failed"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        card = "cpu"
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)

    g = citation_graph(n=args.nodes, feat_dim=128, seed=0)
    cfg = GNNConfig(conv="sage", in_dim=128, hidden=256,
                    out_dim=g.num_classes, layers=3)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device=device)
    eng = ServingEngine(g, params, cfg, q=4, device=device, seed=0)
    pg = eng.pg
    full_bits = 2.0 * 32.0 * pg.halo_demand * sum(exchange_widths(cfg)) * \
        EPOCHS
    for wire in wires:
        for name, (spec, comp) in RUNS[wire].items():
            if only and name not in only:
                continue
            spec = spec.format(half=0.5 * full_bits)
            run = _step_fn(pg, cfg, params, spec, device, wire, comp)
            run(0)
            run(1)                      # warm: kernels built, allocator
            rec = _trace(lambda: run(2), device)
            if device.type == "cuda":
                rec["sync_sites"] = _sync_sites(lambda: run(3))
            if wire == "p2p":
                rec["remote_ell"] = run.remote_ell
            print(json.dumps({"item": "train_step", "wire": wire,
                              "run": name, "policy": spec,
                              "compressor": comp or "randmask", "epoch": 2,
                              **rec}), flush=True)
    if only:
        return 0
    eng.refresh(force=True)             # warm
    rec = _trace(lambda: eng.refresh(force=True), device)
    print(json.dumps({"item": "refresh", "force": True,
                      "forward_ms": eng.timing["forward_s"] * 1e3,
                      "host_copy_ms": eng.timing["host_copy_s"] * 1e3,
                      **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
