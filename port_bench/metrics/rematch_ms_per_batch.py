"""Milliseconds of matching a batch on the registrar machine: the summed
duration of the program's ``nls.match`` spans (the first match and each
rematch of all lanes, on the device) in the traced requests, over the
traced batches."""

from harness import spans


def read(ctx):
    batches = ctx.counters(traced=True).get("batches", 0)
    if ctx.trace is None or not batches or not spans.count(ctx.trace, "nls.match"):
        return None
    return 1e3 * spans.seconds(ctx.trace, "nls.match", within="pb.request") / batches
