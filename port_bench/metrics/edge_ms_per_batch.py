"""Milliseconds a batch at the registrar's host edge: the summed duration
of the program's ``nls.batch.upload`` (padding the scans, their upload)
and ``nls.batch.finalize`` (the copies of the results to the host, their
unpacking) spans in the traced requests, over the traced batches."""

from harness import spans

EDGE = ("nls.batch.upload", "nls.batch.finalize")


def read(ctx):
    batches = ctx.counters(traced=True).get("batches", 0)
    if ctx.trace is None or not batches or not any(spans.count(ctx.trace, n) for n in EDGE):
        return None
    return 1e3 * sum(spans.seconds(ctx.trace, n, within="pb.request") for n in EDGE) / batches
