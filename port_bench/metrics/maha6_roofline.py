"""maha6's share of its roofline in the traced requests: the least time
the card could take for the factors and problems the launches served
(``harness/roofline.py``: bytes at 3.35 TB/s against operations at 67
TFLOP/s) over the device time of the maha6 kernel in the trace."""

import re

from harness import roofline

KERNEL = r"nls::.*\bMaha6\b"


def read(ctx):
    c = ctx.counters(traced=True)
    launches = c.get("maha6_launches", 0)
    if ctx.trace is None or not launches:
        return None
    seconds = ctx.trace.seconds(KERNEL)
    if seconds <= 0.0:
        return None
    bound = launches * roofline.bound_seconds(
        "maha6", c["maha6_factors"] / launches, c["maha6_problems"] / launches)
    return 100.0 * bound / seconds
