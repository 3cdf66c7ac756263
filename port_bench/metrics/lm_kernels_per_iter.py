"""Device operations (kernels, copies, sets) that start inside the
program's ``nls.lm.iter`` spans, over those spans: what one LM iteration
launches."""

from harness import spans


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    n = spans.count(ctx.trace, "nls.lm.iter")
    return len(ctx.trace.ops(within="nls.lm.iter")) / n if n else None
