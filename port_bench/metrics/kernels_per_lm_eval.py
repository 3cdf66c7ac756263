"""Device operations (kernels, copies, sets) of the traced requests over
their LM evaluations (= maha6 launches on the host-driven path)."""


def read(ctx):
    evals = ctx.counters(traced=True).get("maha6_launches", 0)
    if ctx.trace is None or not ctx.trace.device or not evals:
        return None
    return len(ctx.trace.ops(within="pb.request")) / evals
