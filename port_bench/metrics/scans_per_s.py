"""Scans registered in the window over the window's length."""


def read(ctx):
    items = ctx.window.items()
    return items / ctx.window.seconds if items else None
