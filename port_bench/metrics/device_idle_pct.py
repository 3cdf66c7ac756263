"""Share of the traced window in which no device operation ran: 1 - the
union of the device operations' intervals over the window."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct()
