"""Host waits for the device a step: the number of ``sync.*`` spans
inside the ``train.step`` spans, over the window's steps."""


def read(ctx):
    from chipbench import program_spans as ps

    found = ps.of_steps(ctx)
    if found is None:
        return None
    return sum(len(s) for s in ps.within(*found)) / ctx.steps
