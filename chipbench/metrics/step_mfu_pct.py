"""The window's share of the card's float32 peak: the operations its
steps and evaluations need, counted from the shapes
(``chipbench/flops.py``), over the window's seconds times 67 TFLOP/s.
The port computes in float32 with TF32 off, so that peak bounds it."""


def read(ctx):
    if ctx.peaks is None or not ctx.window_s:
        return None
    return 100.0 * ctx.flops / (ctx.window_s * ctx.peaks["f32_flops"])
