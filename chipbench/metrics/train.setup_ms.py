"""Milliseconds a window step of per-job set-up inside ``train_gnn``: the
program's ``train.setup`` spans (entry to the first epoch: the device
arrays, ``attach_p2p``, ``DistMeta.build``, the optimiser, the step
builders) summed over the window, over its steps."""


def read(ctx):
    from chipbench import program_spans as ps

    return ps.total_ms(ctx, "train.setup")
