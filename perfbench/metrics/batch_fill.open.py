"""batch_fill.open: real requests over the slots of the batches the engine
dispatched in the window (its counters), in percent."""


def read(ctx):
    s = ctx.get("engine_stats")
    if not s or s["n_queries"] == 0:
        return None
    return 100.0 * s["n_queries"] / (s["n_queries"] + s["n_padded"])
