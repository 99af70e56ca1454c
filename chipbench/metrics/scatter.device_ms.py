"""Device milliseconds a step of PyTorch's gather, scatter and index
kernels: the edge-list aggregation (on the p2p wire the remote edges, on
the dense wire every edge), the halo's row gathers and their backward
(``indexing_backward_kernel``, the scatter of an indexed read's
cotangent).
Read from the trace by kernel name."""

#: name fragments of PyTorch's index, gather and scatter kernels
KERNELS = ("indexSelect", "indexFunc", "index_elementwise", "scatter_gather",
           "index_put", "gather_kernel", "scatter_add", "index_add",
           "indexing_backward")


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    secs, count = ctx.trace.device_seconds(
        lambda name: any(k in name for k in KERNELS))
    if not count:
        return None
    return secs * 1e3 / ctx.steps
