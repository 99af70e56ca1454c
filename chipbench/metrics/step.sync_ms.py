"""Milliseconds a step the host waits for the device: the ``sync.*``
spans (device-to-host reads, copies from pageable host memory) inside
the ``train.step`` spans, summed over the window, over its steps."""


def read(ctx):
    from chipbench import program_spans as ps

    found = ps.of_steps(ctx)
    if found is None:
        return None
    return sum(ps.union_ns(s) for s in ps.within(*found)) * 1e-6 / ctx.steps
