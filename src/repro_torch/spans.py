"""Named host spans on the profiler's clock.

``with span("train.step"): ...`` marks a stretch of host code as
``repro_torch.train.step``.  A span records only while a
``torch.profiler`` session runs, and then lands among the profile's host
operators, on the same clock as the device's kernels; otherwise it costs
about half a microsecond.  There is no switch and no store of its own:
the profiler keeps the events.

A span is a ``torch._C._profiler._RecordFunctionFast`` (the record
function PyTorch's compilers emit), not ``torch.profiler.
record_function``.  That one costs ~10 us a span with no profiler
running, and records a user annotation, which the profiler mirrors onto
the device's row of the trace: a reader taking that row for device work
would count host spans as busy device time.  ``_RecordFunctionFast``
records a plain host operator, which is not mirrored.

Names are ``<layer>.<what>``; ``sync.<site>`` marks a place where the
host waits for the device (a device-to-host read, or a copy from
pageable host memory, which synchronises the stream).
"""

from __future__ import annotations

import torch

PREFIX = "repro_torch."


def span(name: str):
    """A context manager recording ``repro_torch.<name>`` while a
    profiler runs."""
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)
