"""Device operations that start inside the traced requests' ``solve()``
over their LM evaluations."""


def read(ctx):
    iters = ctx.counters(traced=True).get("lm_iterations", 0)
    if ctx.trace is None or not ctx.trace.device or not iters:
        return None
    return len(ctx.trace.ops(within="pb.solve")) / iters
