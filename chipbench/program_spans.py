"""The program's own spans in a traced window.

The port marks its layers with host spans named
``repro_torch.<layer>.<what>`` (``src/repro_torch/spans.py``).  They are
plain host operators of the profile, so they reach the harness in
``Trace.ops``, on the clock of the device's kernels.  Here they are
picked out by name and summed by interval containment: a span belongs
to an outer one when its start lies inside it, and only its part inside
the outer span (and inside the window) counts.

The per-layer readers built on this (``train.*``, ``step.*``,
``halo.host_ms``) return ``None`` where the trace holds no device
operation: off the card the kernels run inside the host spans, so the
spans would time computation, not host work.  They also return ``None``
where the program has no such span (a program older than the spans).
"""

from __future__ import annotations

import bisect
from functools import lru_cache

PREFIX = "repro_torch."


@lru_cache(maxsize=1)
def _by_name(trace) -> dict:
    """``{name without the prefix: [(start, end)]}`` of the trace's
    program spans."""
    out: dict = {}
    starts, ends, names = trace.ops
    for a, b, n in zip(starts, ends, names):
        if n.startswith(PREFIX):
            out.setdefault(n[len(PREFIX):], []).append((a, b))
    return out


def spans(trace, match) -> list:
    """``(start, end)`` of every program span whose name (without the
    prefix) satisfies ``match``, clipped to the window and sorted by
    start; a span wholly outside the window is dropped."""
    out = []
    for name, found in _by_name(trace).items():
        if match(name):
            for a, b in found:
                a, b = max(a, trace.t0), min(b, trace.t1)
                if b > a:
                    out.append((a, b))
    return sorted(out)


def named(name: str):
    return lambda n: n == name


def is_sync(name: str) -> bool:
    """The host waiting for the device: ``sync.<site>``."""
    return name.startswith("sync.")


def within(outer: list, inner: list) -> list:
    """For each of ``outer``'s intervals, the ``inner`` intervals (sorted
    by start) that start inside it, clipped to its end."""
    starts = [a for a, _ in inner]
    out = []
    for a, b in outer:
        i, j = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
        out.append([(s, min(e, b)) for s, e in inner[i:j]])
    return out


def union_ns(intervals: list) -> int:
    """Nanoseconds covered by ``intervals`` (sorted by start), overlaps
    counted once."""
    total, reach = 0, None
    for a, b in intervals:
        if reach is None or a >= reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def host_ns(outer: list, syncs: list) -> int:
    """Nanoseconds of ``outer`` in which the host did not wait for the
    device: each interval less the ``sync.*`` spans inside it."""
    return sum((b - a) - union_ns(inner)
               for (a, b), inner in zip(outer, within(outer, syncs)))


def of_steps(ctx):
    """``(train.step spans, sync.* spans)`` of a run on the card, or
    ``None`` where there is nothing to read: no trace, no device
    operation in it, no steps, or no ``train.step`` span."""
    if ctx.trace is None or not ctx.trace.busy_s or not ctx.steps:
        return None
    steps = spans(ctx.trace, named("train.step"))
    return (steps, spans(ctx.trace, is_sync)) if steps else None


def total_ms(ctx, name: str):
    """Milliseconds a window step of the spans ``name``, or ``None``
    where there is nothing to read (as :func:`of_steps`)."""
    if of_steps(ctx) is None:
        return None
    found = spans(ctx.trace, named(name))
    return sum(b - a for a, b in found) * 1e-6 / ctx.steps if found \
        else None
