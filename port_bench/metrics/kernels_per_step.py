"""Device operations of the traced requests over their registrar steps."""


def read(ctx):
    steps = ctx.counters(traced=True).get("steps", 0)
    if ctx.trace is None or not ctx.trace.device or not steps:
        return None
    return len(ctx.trace.ops(within="pb.request")) / steps
