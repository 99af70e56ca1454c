"""Host milliseconds a step of issuing the halo exchange: the
``halo.start`` spans inside the ``train.step`` spans (packing, masking,
the host's key draws and block maps, the routing), each less the
``sync.*`` spans inside it (its copies to the card wait for the stream;
``step.sync_ms`` counts them), summed over the window, over its
steps."""


def read(ctx):
    from chipbench import program_spans as ps

    found = ps.of_steps(ctx)
    if found is None:
        return None
    steps, syncs = found
    starts = [s for inside in ps.within(
        steps, ps.spans(ctx.trace, ps.named("halo.start"))) for s in inside]
    return ps.host_ns(starts, syncs) * 1e-6 / ctx.steps
