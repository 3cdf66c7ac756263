"""Registrar machine steps a batch (``NdtRegistrar.run_stats()``): every
lane steps until the slowest is done."""


def read(ctx):
    c = ctx.counters()
    return c["steps"] / c["batches"] if c.get("batches") else None
