"""glue_device_ms: device time a batch in kernels other than the program's
hand-written ones (PyTorch's gathers, sorts, elementwise ops and copies
inside kernels around them), from the profiled batches (closed loops)."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["window"]
    if not ctx["closed"] or not tr or not w["traced"]:
        return None
    own = ctx["hand_written"]
    glue = sum(s for name, s in tr["kernels"] if not any(k in name for k in own))
    return 1e3 * glue / len(w["traced"])
