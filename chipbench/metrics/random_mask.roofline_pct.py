"""``random_mask``'s share of its roofline: the least time its launches
could take over the device time of its kernel (``random_mask_kernel``).

Each launch's least time is the larger of its bytes (every element read
and written once, four bytes each, and the keys) over the memory rate,
and its 32-bit integer operations (76 an element: the Threefry hash and
the compare, as ``chip_smoke.py`` counts them) over the integer peak."""

MASK_INT_OPS = 76


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.mask_launches:
        return None
    secs, count = ctx.trace.device_seconds(lambda n: "random_mask" in n)
    if not count:
        return None
    from chipbench.peaks import bound_s

    least = sum(bound_s(ctx.peaks, 2 * n * 4 + q * 8, MASK_INT_OPS * n,
                        "int32_ops") for n, q in ctx.mask_launches)
    return 100.0 * least / secs
