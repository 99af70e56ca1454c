"""Share of the window the training jobs spend outside their steps:
``1 - (mean History.step_s × steps) / window``.  ``History.step_s`` is
the program's host clock around a step, ending in its loss read; it is
sampled at the evaluated epochs.  What is left is per-job set-up inside
``train_gnn`` (device arrays, halo and ELL lists), the evaluations and
the host loop."""


def read(ctx):
    if not ctx.step_s or not ctx.steps:
        return None
    inside = sum(ctx.step_s) / len(ctx.step_s) * ctx.steps
    return 100.0 * (1.0 - inside / ctx.window_s)
