"""qps: queries answered in the window over the window's time, which runs
from the first dispatch to the last answer on the host (closed loops)."""


def read(ctx):
    if not ctx["closed"]:
        return None
    w = ctx["window"]
    return w["n_queries"] / w["window_s"]
