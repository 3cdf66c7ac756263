"""Milliseconds of ``initialize("chordal")`` a request (host clock,
ending in a synchronise), over the requests outside the traced
segment."""


def read(ctx):
    c = ctx.counters(traced=False)
    return 1e3 * c["init_s"] / c["requests"] if c["requests"] else None
