"""queue_wait_ms.open: mean time from a request's due time to the start of
the engine's drain call that dispatched it (harness clock, every request of
the window)."""
import numpy as np


def read(ctx):
    if ctx["closed"]:
        return None
    w = ctx["window"]
    wait = w["dispatch"] - w["due"]
    if np.isnan(wait).any() or wait.size == 0:
        return None
    return float(wait.mean()) * 1e3
