"""Megabytes the halo exchange ships a step, by the program's ledger:
the window's ``History.transport_gfloats`` over its steps (the paper's
Fig. 5 axis).  On one card the exchange is emulated in device memory, so
it moves ``train_step_ms`` only through the hop buffers the p2p wire
packs, copies and unpacks, which shrink with the kept blocks; the dense
wire gathers full-width blocks at any rate.  Where the partitions sit on
cards of their own, it is what the network carries a step."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.wire_mb / ctx.steps
