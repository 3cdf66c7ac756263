"""Share of the registrar's steps in which every lane was frozen
(``run_stats()``: wasted over steps), the cost of reading the flags once a
block of K steps."""


def read(ctx):
    c = ctx.counters()
    return 100.0 * c["wasted_steps"] / c["steps"] if c.get("steps") else None
