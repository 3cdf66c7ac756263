"""Set-up: seconds from the process's start to the first timed request
(imports, inputs, the port's set-up and warm-up; on a checkout's first run
the kernels' build too)."""


def read(ctx):
    return ctx.setup_s
