"""Blocking reads of the device a scan (the program's ``nls.read`` spans:
``all done`` once an LM iteration, the pose once a solve) over the traced
scans."""

from harness import spans


def read(ctx):
    scans = ctx.counters(traced=True).get("items", 0)
    if ctx.trace is None or not scans:
        return None
    n = spans.count(ctx.trace, "nls.read", within="pb.request")
    return n / scans if n else None
