"""device_idle_pct.closed: share of the profiled stretch in which no kernel,
copy or set ran on the card (closed loops)."""


def read(ctx):
    tr = ctx.get("trace")
    if not ctx["closed"] or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
