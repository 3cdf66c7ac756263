"""Milliseconds a scan: the window's length over the scans registered in
it (closed loop, one scan in flight)."""


def read(ctx):
    items = ctx.window.items()
    return 1e3 * ctx.window.seconds / items if items else None
