"""Share of the registrar machine's blocks replayed from a CUDA graph: 100
times the program's ``nls.graph.replay`` spans over its ``nls.block``
spans, both in the traced requests. A program that replays no graph
reports nothing."""

from harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    replays = spans.count(ctx.trace, "nls.graph.replay", within="pb.request")
    blocks = spans.count(ctx.trace, "nls.block", within="pb.request")
    if not replays or not blocks:
        return None
    return 100.0 * replays / blocks
