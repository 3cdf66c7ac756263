"""Milliseconds an LM iteration of the pose-graph solve: ``solve()``'s
host-clock time (ending in a synchronise) over its LM evaluations, summed
over the requests outside the traced segment."""


def read(ctx):
    c = ctx.counters(traced=False)
    return 1e3 * c["solve_s"] / c["lm_iterations"] if c.get("lm_iterations") else None
