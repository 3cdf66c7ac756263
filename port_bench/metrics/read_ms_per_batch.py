"""Milliseconds a batch that the host waits on reads of the device: the
summed duration of the program's ``nls.read`` spans (the flags after each
block, the six copies of the results) in the traced requests, over the
traced batches."""

from harness import spans


def read(ctx):
    batches = ctx.counters(traced=True).get("batches", 0)
    if ctx.trace is None or not batches or not spans.count(ctx.trace, "nls.read"):
        return None
    return 1e3 * spans.seconds(ctx.trace, "nls.read", within="pb.request") / batches
