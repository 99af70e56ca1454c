"""Reading a ``torch.profiler`` trace of the measured window.

:func:`read` takes the raw events of a finished profile: every operation
that ran on the device (kernels, copies, fills) with its interval, the
harness's own spans (``record_function`` names starting ``chipbench.``)
and the host's operators.  From them:

* ``busy_s``: the seconds in which some operation ran on the device (the
  union of their intervals, so overlapping operations count once);
* ``window_s``: the traced window, the span ``chipbench.window``;
* ``by_name``: device seconds and counts by operation name;
* ``idle``: the gaps in the window with no device operation, each named
  by what the host was doing at its middle: the innermost harness span
  and the innermost host operator.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import numpy as np

#: gaps shorter than this are summed under one name, not attributed
SHORT_GAP_NS = 20_000
SPAN_PREFIX = "chipbench."


class Trace:
    """The device's operations and the host's spans and operators of one
    traced window (``chipbench.window``), in nanoseconds."""

    def __init__(self, dev_names, dev_start, dev_end, spans, ops):
        self.dev_names = dev_names
        self.dev_start = np.asarray(dev_start, np.int64)
        self.dev_end = np.asarray(dev_end, np.int64)
        self.spans = spans          # [(name, start, end)]
        self.ops = ops              # (starts, ends, names), sorted by start
        self.t0, self.t1 = next((s[1], s[2]) for s in spans
                                if s[0] == SPAN_PREFIX + "window")
        self.window_s = (self.t1 - self.t0) * 1e-9
        self._merge()

    def _merge(self):
        """Union of the device intervals inside the window."""
        s = np.clip(self.dev_start, self.t0, self.t1)
        e = np.clip(self.dev_end, self.t0, self.t1)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        merged = []
        for a, b in zip(s.tolist(), e.tolist()):
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy = merged
        self.busy_s = sum(b - a for a, b in merged) * 1e-9

    def by_name(self) -> dict:
        """``{name: [device seconds, count]}`` of the device operations."""
        out: dict = defaultdict(lambda: [0.0, 0])
        for name, a, b in zip(self.dev_names, self.dev_start.tolist(),
                              self.dev_end.tolist()):
            out[name][0] += (b - a) * 1e-9
            out[name][1] += 1
        return dict(out)

    def device_seconds(self, match) -> tuple[float, int]:
        """Device seconds and count of the operations whose name
        satisfies ``match``."""
        hits = [v for name, v in self.by_name().items() if match(name)]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def gaps(self) -> list:
        """``(start, end)`` of every idle stretch inside the window."""
        out, t = [], self.t0
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def _innermost(self, starts, ends, names, t: int) -> str | None:
        j = bisect.bisect_right(starts, t) - 1
        for _ in range(256):
            if j < 0:
                return None
            if ends[j] > t:
                return names[j]
            j -= 1
        return None

    def idle_by_host(self) -> dict:
        """Idle seconds summed by what the host was doing."""
        span_s = [s[1] for s in self.spans]
        span_e = [s[2] for s in self.spans]
        span_n = [s[0][len(SPAN_PREFIX):] for s in self.spans]
        op_s, op_e, op_n = self.ops
        out: dict = defaultdict(float)
        for a, b in self.gaps():
            if b - a < SHORT_GAP_NS:
                out["gaps under 20 us"] += (b - a) * 1e-9
                continue
            mid = (a + b) // 2
            span = self._innermost(span_s, span_e, span_n, mid) or "window"
            op = self._innermost(op_s, op_e, op_n, mid) or "python"
            out[f"{span}: {op}"] += (b - a) * 1e-9
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, v[0]) for n, v in self.by_name().items()),
                     key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle_by_host().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in idle[:top]]}


def read(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    dev_names, dev_start, dev_end = [], [], []
    spans, ops = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        end = start + ev.duration_ns()
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            if name.startswith(SPAN_PREFIX):
                continue        # a host span mirrored on the device's row
            dev_names.append(name)
            dev_start.append(start)
            dev_end.append(end)
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, start, end))
        else:
            ops.append((start, end, name))
    spans.sort(key=lambda s: s[1])
    ops.sort(key=lambda o: o[0])
    op_cols = ([o[0] for o in ops], [o[1] for o in ops], [o[2] for o in ops])
    return Trace(dev_names, dev_start, dev_end, spans, op_cols)
