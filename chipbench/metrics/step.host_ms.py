"""Host milliseconds a step in which the host issues work rather than
waits: each ``train.step`` span (``History.step_s``'s interval, the
loss read included) less the ``sync.*`` spans inside it, summed over the
window, over its steps.  With ``step.sync_ms`` it makes up the mean
step."""


def read(ctx):
    from chipbench import program_spans as ps

    found = ps.of_steps(ctx)
    if found is None:
        return None
    return ps.host_ns(*found) * 1e-6 / ctx.steps
