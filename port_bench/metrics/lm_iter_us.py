"""Microseconds an LM iteration on the host: the mean duration of the
program's ``nls.lm.iter`` spans (one iteration of ``solvers/lm.solve_batch``,
its ``all done`` read included) in the traced requests."""

from harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    found = spans.named(ctx.trace, "nls.lm.iter", within="pb.request")
    return 1e6 * sum(h.end - h.start for h in found) / len(found) if found else None
