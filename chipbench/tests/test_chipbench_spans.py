"""The readers of the program's spans (``chipbench/program_spans.py`` and
the ``train.*``, ``step.*`` and ``halo.host_ms`` metrics), on synthetic
traces whose numbers are worked out by hand.

    python -m pytest -q chipbench/tests/test_chipbench_spans.py
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from chipbench import program_spans as ps  # noqa: E402
from chipbench import run as bench  # noqa: E402
from chipbench import trace as tracelib  # noqa: E402

SPAN_METRICS = ("train.setup_ms", "train.eval_ms", "step.host_ms",
                "step.sync_ms", "step.syncs", "halo.host_ms")
US = 1_000                                  # the trace's clock is in ns


def reader(name: str):
    return bench.load_file(bench.BENCH / "metrics" / f"{name}.py",
                           f"span_reader_{name}")


def make_trace(program: list, device=((0, 10 * US),), t1=1000 * US):
    """A trace of a window ``[0, t1)`` whose host operators are the
    ``program`` spans ``(name, start us, end us)`` (prefixed) and one
    aten operator, with ``device`` busy intervals in us."""
    ops = sorted([(a * US, b * US, "repro_torch." + n) for n, a, b in program]
                 + [(5 * US, 6 * US, "aten::mm")])
    cols = ([o[0] for o in ops], [o[1] for o in ops], [o[2] for o in ops])
    return tracelib.Trace(["k"] * len(device),
                          [a * US for a, _ in device],
                          [b * US for _, b in device],
                          [("chipbench.window", 0, t1)], cols)


def ctx_of(trace, steps: int):
    return SimpleNamespace(trace=trace, steps=steps)


# Two jobs in one window.  The first job's set-up starts before the
# window (at -40 us) and is cut at 0; the second's lies inside.  Step 1
# holds two halo starts, the first with a key draw and a sync inside, and
# two syncs, one nested in the other; step 2 one halo start and one sync.
# A sync and a halo start in the evaluation, outside every step, are not
# the step's; a step past the window's end is cut.
PROGRAM = [
    ("train.setup", -40, 60),
    ("train.setup.attach_p2p", 10, 50),        # a child: not counted again
    ("train.step", 100, 200),
    ("halo.start", 110, 130),
    ("halo.keys", 112, 118),
    ("sync.halo_maps", 115, 118),
    ("halo.start", 140, 150),
    ("sync.loss", 170, 195),
    ("sync.inner", 180, 190),                  # inside sync.loss: once
    ("train.evaluate", 200, 260),
    ("halo.start", 210, 220),
    ("sync.eval", 250, 258),
    ("train.setup", 300, 320),
    ("train.step", 400, 460),
    ("halo.start", 405, 425),
    ("sync.step_metrics", 440, 444),
    ("train.step", 990, 1100),                 # cut at the window's end
    ("sync.loss", 995, 1000),
]


@pytest.fixture
def ctx():
    return ctx_of(make_trace(PROGRAM), steps=3)


def test_setup_and_evaluation_by_hand(ctx):
    # set-up: 60 (cut at the window's start) + 20 us over 3 steps
    assert reader("train.setup_ms").read(ctx) == pytest.approx(80e-3 / 3)
    assert reader("train.eval_ms").read(ctx) == pytest.approx(60e-3 / 3)


def test_step_host_and_sync_by_hand(ctx):
    # steps: 100 + 60 + 10 (cut) us; syncs inside them: 3 + 25 (the
    # nested one once) in step 1, 4 in step 2, 5 in the cut step
    sync = 3 + 25 + 4 + 5
    assert reader("step.sync_ms").read(ctx) == pytest.approx(sync * 1e-3 / 3)
    assert reader("step.host_ms").read(ctx) == \
        pytest.approx((170 - sync) * 1e-3 / 3)
    # host + sync is the mean step; the evaluation's sync is not in it
    assert reader("step.syncs").read(ctx) == pytest.approx(5 / 3)


def test_halo_host_by_hand(ctx):
    # halo starts inside steps: 20 - 3 (its sync) + 10 + 20; the one in
    # the evaluation is not counted
    assert reader("halo.host_ms").read(ctx) == pytest.approx(47e-3 / 3)


def test_containment_helpers():
    inner = [(1, 4), (2, 3), (5, 9), (12, 14)]
    assert ps.within([(0, 6), (10, 20)], inner) == [[(1, 4), (2, 3), (5, 6)],
                                                   [(12, 14)]]
    assert ps.union_ns([(1, 4), (2, 3), (3, 6), (8, 9)]) == 6
    assert ps.union_ns([]) == 0
    assert ps.host_ns([(0, 10)], [(2, 4), (3, 5)]) == 7


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_no_device_operation_reads_nothing(name):
    """Off the card (no device operation in the trace) and without a
    trace a reader returns None."""
    assert reader(name).read(ctx_of(make_trace(PROGRAM, device=()), 3)) \
        is None
    assert reader(name).read(ctx_of(None, 3)) is None
    assert reader(name).read(ctx_of(make_trace(PROGRAM), 0)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_spans_reads_nothing(name):
    """A program older than the spans (the trace has only its aten
    operators) gets no number, and no error."""
    assert reader(name).read(ctx_of(make_trace([]), 3)) is None


def test_every_cell_reports_the_span_metrics():
    spec = bench.load_json(ROOT / "BENCHMARK.json")
    cells = [c["name"] for c in spec["workloads"]]
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["moves"] == "train_step_ms"
        assert m["workloads"] == cells
