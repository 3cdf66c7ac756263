"""Milliseconds of matching a scan: the summed duration of the program's
``nls.match`` spans (one an outer iteration, the pose upload included) in
the traced requests, over the traced scans."""

from harness import spans


def read(ctx):
    scans = ctx.counters(traced=True).get("items", 0)
    if ctx.trace is None or not scans or not spans.count(ctx.trace, "nls.match"):
        return None
    return 1e3 * spans.seconds(ctx.trace, "nls.match", within="pb.request") / scans
