"""Microseconds of host time a registrar step: the summed duration of the
program's ``nls.block`` spans (K steps enqueued, no read inside) in the
traced requests, over the traced steps."""

from harness import spans


def read(ctx):
    steps = ctx.counters(traced=True).get("steps", 0)
    if ctx.trace is None or not steps or not spans.count(ctx.trace, "nls.block"):
        return None
    return 1e6 * spans.seconds(ctx.trace, "nls.block", within="pb.request") / steps
