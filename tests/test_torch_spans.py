"""The port's host spans (``repro_torch.spans``) on ``train_gnn``'s path,
read from a ``torch.profiler`` trace on the CPU.

One small job on the p2p wire under ``varco`` (``blockmask``) and one on
the dense wire under ``varco`` (``randmask``), each run under the
profiler and again without it: the spans' counts per job, step, layer
and evaluation, their nesting, their event kind (a plain host operator,
never a user annotation, which the profiler mirrors onto the device's
row), and the job's results, bitwise the same with the profiler on.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_dist_cases as cases
from repro_torch.core.varco import CommPolicy
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.synthetic import citation_graph
from repro_torch.spans import PREFIX, span
from repro_torch.train.trainer import train_gnn

EPOCHS, EVAL_EVERY, LAYERS = 3, 2, 3
EVALS = 2                       # epochs 0 and 2 (the last)
#: host waits a step: per layer the wire's copies to the card (p2p
#: varco: the kept and inverse block maps and the two routing indices;
#: dense varco: the worker keys), and the ledger's bits on every wire;
#: then the step's metrics read and the loss read
SYNCS_PER_STEP = {"p2p": LAYERS * (4 + 1) + 2, "dense": LAYERS * (1 + 1) + 2}
WIRES = {"p2p": "blockmask", "dense": "randmask"}


def run_job(wire: str):
    g = citation_graph(n=400, n_classes=4, feat_dim=128, seed=3)
    pg = partition_graph(g, 4, scheme="random", seed=0)
    policy = CommPolicy.parse("varco:linear:5", EPOCHS,
                              compressor=WIRES[wire])
    return train_gnn(pg, policy=policy, epochs=EPOCHS, hidden=128,
                     layers=LAYERS, wire=wire, device="cpu", seed=5,
                     eval_every=EVAL_EVERY)


@pytest.fixture(scope="module", params=sorted(WIRES))
def jobs(request):
    """``(wire, the job's events, result under the profiler, result
    without it)``."""
    with cases.one_thread():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = run_job(request.param)
        plain = run_job(request.param)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(PREFIX)]
    return request.param, events, traced, plain


def intervals(events, name: str) -> list:
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events if e.name() == PREFIX + name)


def inside(iv, outer: list) -> bool:
    return any(a <= iv[0] and iv[1] <= b for a, b in outer)


def test_counts_per_job_step_layer_and_evaluation(jobs):
    wire, events, _, _ = jobs
    count = {}
    for e in events:
        name = e.name()[len(PREFIX):]
        count[name] = count.get(name, 0) + 1
    setup_children = {"train.setup.device_arrays", "train.setup.meta",
                      "train.setup.steps"} | \
        ({"train.setup.attach_p2p"} if wire == "p2p" else set())
    for name in ("train.setup", *setup_children):
        assert count.pop(name) == 1, name
    assert count.pop("train.step") == EPOCHS
    assert count.pop("train.evaluate") == EVALS
    forwards = EPOCHS + EVALS
    assert count.pop("halo.start") == LAYERS * forwards
    assert count.pop("halo.complete") == LAYERS * forwards
    for name in ("step.forward", "step.backward", "step.update",
                 "sync.step_metrics", "sync.loss"):
        assert count.pop(name) == EPOCHS, name
    assert count.pop("sync.eval") == EVALS
    # the key draws run in every compressed exchange (the evaluation's
    # full-communication forward draws none)
    assert count.pop("halo.keys") == LAYERS * EPOCHS
    # the ledger's bits go to the card in every exchange
    assert count.pop("sync.halo_bits") == LAYERS * forwards
    if wire == "p2p":
        assert count.pop("sync.halo_maps") == 4 * LAYERS * EPOCHS
    else:
        assert count.pop("sync.keys") == LAYERS * EPOCHS
    assert count == {}


def test_syncs_per_step(jobs):
    wire, events, _, _ = jobs
    syncs = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if e.name().startswith(PREFIX + "sync."))
    for step in intervals(events, "train.step"):
        assert sum(inside(s, [step]) for s in syncs) == \
            SYNCS_PER_STEP[wire]


def test_nesting(jobs):
    _, events, _, _ = jobs
    steps = intervals(events, "train.step")
    evals = intervals(events, "train.evaluate")
    setup = intervals(events, "train.setup")
    assert not any(inside(s, setup) for s in steps + evals)
    for e in events:
        name = e.name()[len(PREFIX):]
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        if name.startswith(("halo.", "step.")):
            assert inside(iv, steps + evals), name
        if name.startswith(("step.", "halo.keys")):
            assert inside(iv, steps), name
        if name.startswith("train.setup."):
            assert inside(iv, setup), name
        if name in ("sync.loss", "sync.step_metrics"):
            assert inside(iv, steps), name
        if name == "sync.eval":
            assert inside(iv, evals), name


def test_spans_are_plain_host_operators(jobs):
    _, events, _, _ = jobs
    assert events
    for e in events:
        assert e.activity_type() == "cpu_op", e.name()
        assert not e.is_user_annotation(), e.name()
        assert str(e.device_type()).endswith("CPU"), e.name()


def test_results_bitwise_with_and_without_the_profiler(jobs):
    _, _, traced, plain = jobs
    timing = {"wall_s", "step_s"}
    for f in dataclasses.fields(traced.history):
        if f.name not in timing:
            assert getattr(traced.history, f.name) == \
                getattr(plain.history, f.name), f.name
    assert len(traced.history.step_s) == EVALS
    for a, b in zip(traced.params["layers"], plain.params["layers"]):
        for key in a:
            for leaf in a[key]:
                assert torch.equal(a[key][leaf], b[key][leaf])


def test_nothing_is_recorded_without_a_profiler():
    with span("train.step"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith(PREFIX)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("train.step"):
            pass
    assert [e.name() for e in prof.profiler.kineto_results.events()] == \
        [PREFIX + "train.step"]
