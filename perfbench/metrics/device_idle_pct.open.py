"""device_idle_pct.open: share of the profiled stretch in which no kernel,
copy or set ran on the card (open loops)."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["closed"] or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
