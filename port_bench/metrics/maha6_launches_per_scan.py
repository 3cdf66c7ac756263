"""maha6 launches a scan over the window (the port's counter
``ops.cuda_kernels.LAUNCHES``): on the host-driven path one a LM
evaluation."""


def read(ctx):
    c = ctx.counters()
    return c["maha6_launches"] / c["items"] if c["items"] else None
