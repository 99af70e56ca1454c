"""Milliseconds a window step of evaluation: the program's
``train.evaluate`` spans (the full-communication forward over the
splits and its accuracy reads, every ``eval_every`` epochs) summed over
the window, over its steps."""


def read(ctx):
    from chipbench import program_spans as ps

    return ps.total_ms(ctx, "train.evaluate")
