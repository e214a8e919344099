"""search_host_ms: mean host time a batch spends inside the search call
(``search_lider``: routing into the query-path graphs, their replay, the
outputs' copies), over the window's untraced batches (closed loops)."""


def read(ctx):
    if not ctx["closed"]:
        return None
    w = ctx["window"]
    traced = set(w["traced"])
    host = [s for i, s in enumerate(w["host_s"]) if i not in traced]
    return 1e3 * sum(host) / len(host) if host else None
