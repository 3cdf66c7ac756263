"""Milliseconds a solve: the window's length over the graphs solved in it
(reset, initialization and solve; closed loop, one in flight)."""


def read(ctx):
    items = ctx.window.items()
    return 1e3 * ctx.window.seconds / items if items else None
