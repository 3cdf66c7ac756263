"""The 90th percentile, in milliseconds, of the latencies of all scans of
the window (numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    lat = ctx.window.latencies()
    return 1e3 * float(np.percentile(lat, 90)) if lat else None
