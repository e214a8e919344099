"""p95_ms: the 95th percentile, over every request due in the window, of the
time from when it was due to its answer on the host (open loops)."""
import numpy as np


def read(ctx):
    if ctx["closed"]:
        return None
    w = ctx["window"]
    lat = w["answer"] - w["due"]
    if np.isnan(lat).any() or lat.size == 0:
        return None
    return float(np.percentile(lat, 95)) * 1e3
