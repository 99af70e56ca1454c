"""Cells that train GraphSAGE through ``repro_torch.train.trainer.train_gnn``.

Set-up (``setup_s``): the program's import, the configuration's graph
(the frozen generator of ``chipbench/graphgen.py``, seeded by the
configuration), the program's partitioner, the weights drawn on the card
from ``--seed``, and one untimed job of two epochs with the cell's
traffic (it loads every kernel the jobs launch and sizes the
allocator).

The window runs whole jobs back to back: one job is one ``train_gnn``
call of the traffic's ``job_epochs`` epochs from the seeded weights, the
policy's schedule spanning that job.  It closes at the end of the job
that is running when the seconds have passed.  A job pays its own set-up
inside ``train_gnn`` (the device arrays, the halo and ELL lists) and its
evaluations, as a training run does.

The program is observed from outside only: ``train_gnn``'s
``optimizer=`` argument gets the program's own AdamW wrapped to copy the
first gradient it is handed and the parameters it is handed after the
compared steps; ``trainer.make_train_step`` and ``make_eval_step`` are
wrapped to keep each step's loss and to open the harness's spans; the
``ops`` module's kernel entries are wrapped to note each launch's shapes.
None of it reads the device inside the window.

``correct`` compares every job of the window with the plain reference
(``chipbench/reference.py``), run once after the window from the same
graph, partition and weights, at the steps ``reference.steps_compared``
names: the first three (under ``varco`` the most compressed) and the
first four at full rate, after the schedule's ramp.  The numbers are the
steps' losses, the first gradient's norm by leaf and each leaf's change
over the first three steps and over every step to the last full-rate one
(``reference.gaps``), against the cell's limits in
``chipbench/limits/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from chipbench import flops as flopcount
from chipbench import graphgen, reference
from chipbench.peaks import peaks_for

#: epochs of the untimed warm-up job
WARMUP_EPOCHS = 2


def _span(tracing: bool, name: str):
    if not tracing:
        return contextlib.nullcontext()
    return torch.profiler.record_function("chipbench." + name)


class Recorder:
    """What the harness notes of the program while it runs, from outside:
    per job the step losses, the first gradient and the parameters after
    the early and the full-rate steps ``reference.steps_compared`` names
    for ``traffic``, and each kernel launch's shapes."""

    def __init__(self, traffic: dict, tracing: bool):
        plan = reference.steps_compared(traffic)
        self.tracing = tracing
        self.keep_after = (len(plan["early"]), plan["follow"])
        self.jobs: list[dict] = []
        self.ell: list[tuple] = []
        self.mask: list[tuple] = []
        self._undo: list = []

    def new_job(self) -> None:
        self.jobs.append({"losses": [], "updates": 0, "grad0": None,
                          "params": {}})

    def _patch(self, module, name, wrapper) -> None:
        orig = getattr(module, name)
        self._undo.append((module, name, orig))
        setattr(module, name, wrapper(orig))

    def install(self) -> None:
        from repro_torch.kernels import ops
        from repro_torch.train import trainer

        def make_step(orig):
            def make(*args, **kwargs):
                step = orig(*args, **kwargs)

                def recorded(*a, **k):
                    with _span(self.tracing, "step"):
                        out = step(*a, **k)
                    self.jobs[-1]["losses"].append(out[2]["loss"])
                    return out
                return recorded
            return make

        def make_eval(orig):
            def make(*args, **kwargs):
                evaluate = orig(*args, **kwargs)

                def spanned(*a, **k):
                    with _span(self.tracing, "evaluate"):
                        return evaluate(*a, **k)
                return spanned
            return make

        def ell(orig):
            def launch(x, nbr, w):
                self.ell.append((tuple(x.shape), tuple(nbr.shape)))
                return orig(x, nbr, w)
            return launch

        def mask(orig):
            def launch(x, *a, **k):
                self.mask.append((x.numel(), x.shape[0]))
                return orig(x, *a, **k)
            return launch

        self._patch(trainer, "make_train_step", make_step)
        self._patch(trainer, "make_eval_step", make_eval)
        self._patch(ops, "ell_spmm", ell)
        self._patch(ops, "random_mask_kernel", mask)

    def uninstall(self) -> None:
        while self._undo:
            module, name, orig = self._undo.pop()
            setattr(module, name, orig)

    def optimizer(self, lr: float, weight_decay: float):
        """The program's AdamW, copying what the checks read."""
        from repro_torch.train.optim import Optimizer, adamw

        base = adamw(lr, weight_decay=weight_decay)

        def update(grads, state, params):
            job = self.jobs[-1]
            job["updates"] += 1
            if job["updates"] == 1:
                job["grad0"] = [g.detach().clone()
                                for g in reference.leaves(grads)]
            if job["updates"] - 1 in self.keep_after:
                job["params"][job["updates"] - 1] = [
                    p.detach().clone() for p in reference.leaves(params)]
            return base.update(grads, state, params)

        return Optimizer(base.init, update)


def make_graph(cfg: dict) -> dict:
    """The configuration's graph: its structure, features and split come
    from the configuration's own ``graph.seed``, so every run's work has
    the same sizes (ogbn-arxiv is one graph; the runs vary the weights)."""
    g = cfg["graph"]
    return graphgen.citation_graph(
        n=g["nodes"], n_classes=g["classes"], feat_dim=g["feat_dim"],
        avg_degree=g["avg_degree"], homophily=g["homophily"],
        feature_signal=g["feature_signal"], splits=g["splits"],
        seed=g["seed"])


def make_weights(dims, seed: int, device) -> dict:
    """GraphSAGE weights in the program's tree layout, LeCun-normal from
    one draw of a generator on ``device`` seeded with ``seed``; zero
    biases."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [a * b for a, b in dims for _ in range(2)]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    parts = iter(torch.split(flat, sizes))
    layers = []
    for a, b in dims:
        std = 1.0 / float(np.sqrt(a))
        w_self = next(parts).reshape(a, b) * std
        w_neigh = next(parts).reshape(a, b) * std
        layers.append({"self": {"w": w_self,
                                "b": torch.zeros(b, device=device)},
                       "neigh": {"w": w_neigh}})
    return {"layers": layers}


def setup(cfg: dict, seed: int, device, phases: dict) -> tuple:
    """The inputs of a run: ``(graph, partitioned graph, weights, layer
    dims)``; the graph and the program's partition of it are the
    configuration's, the weights are drawn from ``seed``.  Seconds of each
    phase land in ``phases``."""
    from repro_torch.graph.data import GraphData
    from repro_torch.graph.partition import partition_graph

    part = cfg["partition"]
    dims = flopcount.layer_dims(cfg["graph"]["feat_dim"],
                                cfg["model"]["hidden"],
                                cfg["graph"]["classes"],
                                cfg["model"]["layers"])
    t = time.perf_counter()
    graph = make_graph(cfg)
    phases["graph"] = time.perf_counter() - t
    t = time.perf_counter()
    pg = partition_graph(
        GraphData(graph["indptr"], graph["indices"], graph["features"],
                  graph["labels"], graph["train_mask"], graph["val_mask"],
                  graph["test_mask"]),
        part["q"], scheme=part["scheme"], seed=part["seed"])
    phases["partition"] = time.perf_counter() - t
    t = time.perf_counter()
    params0 = make_weights(dims, seed, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    phases["weights"] = time.perf_counter() - t
    return graph, pg, params0, dims


def job(pg, cfg: dict, traffic: dict, rec: Recorder, params0, seed: int,
        device, epochs: int, stop_after: int | None = None):
    """One job: a ``train_gnn`` call of ``epochs`` epochs from
    ``params0`` under the traffic's policy, its schedule spanning the
    job, observed by ``rec``; its ``History``."""
    from repro_torch.core.varco import CommPolicy
    from repro_torch.train import trainer

    model, recipe = cfg["model"], cfg["recipe"]
    rec.new_job()
    policy = CommPolicy.parse(traffic["policy"], epochs,
                              compressor=traffic["compressor"])
    with _span(rec.tracing, "train_gnn"):
        return trainer.train_gnn(
            pg, policy=policy, epochs=epochs, lr=recipe["lr"],
            weight_decay=recipe["weight_decay"], hidden=model["hidden"],
            layers=model["layers"], conv=model["conv"], seed=seed,
            eval_every=traffic["eval_every"],
            optimizer=rec.optimizer(recipe["lr"], recipe["weight_decay"]),
            wire=traffic["wire"], device=device, params=params0,
            stop_after=stop_after).history


def _layout_counts(graph: dict, owner: np.ndarray) -> dict:
    """Host counts the kernels' rooflines need: local (same-partition)
    directed edges, and the nodes with at least one of them."""
    dst, src = graphgen.edge_list(graph)
    local = owner[dst] == owner[src]
    n = len(graph["indptr"]) - 1
    return {"nodes": n, "edges": int(len(dst)),
            "local_edges": int(local.sum()),
            "local_rows": int((np.bincount(dst[local], minlength=n) > 0)
                              .sum())}


def run(cell: dict, cfg: dict, traffic: dict, limits: dict, seed: int,
        seconds: float, tracing: bool, device, t_start: float) -> dict:
    """One run of a cell: set-up, the window, the checks.  Returns ``{
    "metrics": {name: value}, "attempted", "failed", "checks": {name:
    [value, limit]}, "correct", "memory_peak_bytes", "trace",
    "context"}``."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    phases = {"import": time.perf_counter() - t_start}
    graph, pg, params0, dims = setup(cfg, seed, device, phases)
    rec = Recorder(traffic, tracing)
    rec.install()
    try:
        t = time.perf_counter()
        job(pg, cfg, traffic, rec, params0, seed, device, WARMUP_EPOCHS)
        warm = len(rec.jobs)
        rec.ell.clear()
        rec.mask.clear()
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        phases["warm-up job"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start

        prof = None
        if tracing:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        histories = []
        t0 = time.perf_counter()
        with _span(tracing, "window"):
            while True:
                histories.append(job(pg, cfg, traffic, rec, params0, seed,
                                     device, traffic["job_epochs"]))
                if time.perf_counter() - t0 >= seconds:
                    break
            if on_card:
                torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
    finally:
        rec.uninstall()
    # the caching allocator's peak on the card since the warm-up job, read
    # by the harness from PyTorch and not from the program
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    jobs = rec.jobs[warm:]
    steps = sum(len(j["losses"]) for j in jobs)
    evals = sum(len(h.epoch) for h in histories)
    losses = torch.stack([loss.reshape(()).float().cpu()
                          for j in jobs for loss in j["losses"]])
    failed = int((~torch.isfinite(losses)).sum())
    wire_mb = sum(h.total_transport_gfloats for h in histories) * 4e3
    counts = _layout_counts(graph, np.asarray(pg.owner))
    metrics = {"train_step_ms": window_s * 1e3 / steps,
               "peak_device_GB": peak / 1e9, "setup_s": setup_s}
    trace = None
    if prof is not None:
        from chipbench import trace as tracelib
        trace = tracelib.read(prof)
        del prof
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    # what the per-layer readers (chipbench/metrics) read
    ctx = SimpleNamespace(
        cell=cell["name"], steps=steps, evals=evals, window_s=window_s,
        step_s=[s for h in histories for s in h.step_s], wire_mb=wire_mb,
        flops=steps * flopcount.train_step_flops(
            counts["nodes"], counts["edges"], dims) +
        evals * flopcount.forward_flops(counts["nodes"], counts["edges"],
                                        dims),
        ell_launches=list(rec.ell), mask_launches=list(rec.mask),
        counts=counts, peaks=peaks_for(name), trace=trace)

    # the checks: the program's state goes first, then the reference runs
    owner = np.asarray(pg.owner)
    del histories, pg
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, correct = check(graph, owner, params0, cfg, traffic, limits,
                            [program_readings(j, traffic) for j in jobs],
                            device)
    return {"metrics": metrics, "attempted": steps, "failed": failed,
            "checks": checks, "correct": correct and failed == 0,
            "memory_peak_bytes": peak, "trace": trace, "context": ctx,
            "device_name": name, "setup_phases": phases, "jobs": len(jobs)}


def program_readings(job: dict, traffic: dict) -> dict | None:
    """A job's recorded steps in the reference's form (``None`` where it
    recorded too few)."""
    plan = reference.steps_compared(traffic)
    keep = (len(plan["early"]), plan["follow"])
    if len(job["losses"]) < plan["follow"] or \
            any(k not in job["params"] for k in keep):
        return None
    return {"loss": [float(x) for x in job["losses"][:plan["follow"]]],
            "grad0": job["grad0"], "params": job["params"]}


def check(graph, owner, params0, cfg, traffic, limits, readings,
          device) -> tuple[dict, bool]:
    """Each of ``readings`` (:func:`program_readings` of a job, ``None``
    where a job recorded too few steps) against one reference run:
    ``({name: [worst reading, limit]}, correct)``."""
    part = cfg["partition"]
    try:
        reference.check_partition(owner, len(graph["indptr"]) - 1,
                                  part["q"], part["scheme"], part["seed"],
                                  part["slack"])
        partition_ok = 1.0
    except ValueError:
        partition_ok = 0.0
    ref = reference.run(graph, owner, params0, traffic, cfg["recipe"],
                        device)
    plan = reference.steps_compared(traffic)
    worst = dict.fromkeys(("loss", "grad", "change", "full_rate_loss",
                           "full_rate_change"), 0.0)
    for r in readings or [None]:
        gaps = reference.gaps(r, ref, params0, plan) if r is not None \
            else dict.fromkeys(worst, float("inf"))
        for k, v in gaps.items():
            worst[k] = max(worst[k], v)
    checks = {"partition_valid": [partition_ok, 1.0]}
    for k, v in worst.items():
        checks[f"{k}_gap"] = [v, limits[f"{k}_gap"]]
    correct = partition_ok == 1.0 and all(
        v <= lim for k, (v, lim) in checks.items() if k != "partition_valid")
    return checks, correct
