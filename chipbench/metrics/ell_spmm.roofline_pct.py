"""``ell_spmm``'s share of its roofline: the least time its launches
could take over the device time of its kernel (``ell_spmm_slice_kernel``
in the trace).

Each launch's least time is the larger of its bytes over the memory rate
and its operations over the float32 peak (``chipbench/peaks.py``),
counted as ``chip_smoke.py`` counts them: every source row the lists
reference read once, the padded neighbour and weight lists read, the
output written; two operations per stored edge and column.  The rows and
edges are the partition's local ones (the forward lists and the reversed
lists of the backward reference the same nodes, the graph being
symmetric), counted on the host from the graph and the partition."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.ell_launches:
        return None
    secs, count = ctx.trace.device_seconds(lambda n: "ell_spmm" in n)
    if not count:
        return None
    from chipbench.peaks import bound_s

    rows, nnz = ctx.counts["local_rows"], ctx.counts["local_edges"]
    least = 0.0
    for (q, _, f), (_, n_dst, k) in ctx.ell_launches:
        n_bytes = rows * f * 4 + 2 * q * n_dst * k * 4 + q * n_dst * f * 4
        least += bound_s(ctx.peaks, n_bytes, 2.0 * nnz * f)
    return 100.0 * least / secs
