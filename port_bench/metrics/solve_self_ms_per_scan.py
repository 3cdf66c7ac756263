"""Milliseconds a scan that the minimizers' ``solve`` spends outside its
LM iterations: the self time of the program's ``nls.solve`` spans (less
their ``nls.lm.iter`` children: the cast, pad and pack, the pose upload
and read-back) in the traced requests, over the traced scans."""

from harness import spans


def read(ctx):
    scans = ctx.counters(traced=True).get("items", 0)
    if ctx.trace is None or not scans or not spans.count(ctx.trace, "nls.solve"):
        return None
    own = spans.self_seconds(ctx.trace, "nls.solve", ["nls.lm.iter"], within="pb.request")
    return 1e3 * own / scans
