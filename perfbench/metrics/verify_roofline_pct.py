"""verify_roofline_pct: the verification kernel's least time over its device
time in the profiled batches (closed loops).

Least time is the larger of two bounds, for the routing call and the
in-cluster call of each batch: bytes (each distinct row the batch's
candidates name read once, the queries read, the top-k written) over the
HBM bandwidth, and operations (2 d for each distinct (query, row) pair) over
the TF32 peak, so that a kernel keeping float32 accuracy by split TF32
passes cannot read over 100%. The rows and pairs are counted on the
reference's candidates, not by the program."""
import sys

from pbench.peaks import H100

KERNEL = "fused_verify_kernel"


def _least(rows, pairs, queries, outs, d):
    by_bytes = (rows * d * 4 + queries * d * 4 + outs * 8) / H100["hbm_bytes_per_s"]
    by_ops = 2 * d * pairs / H100["tf32_flops"]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "ops"


def read(ctx):
    tr, vw = ctx.get("trace"), ctx.get("verify_work")
    if not ctx["closed"] or not tr or not vw:
        return None
    dev_s = sum(s for name, s in tr["kernels"] if KERNEL in name)
    if dev_s <= 0:
        return None
    cfg = ctx["config"]
    d, nq = cfg["dim"], vw["batches"] * vw["batch"]
    r, rb = _least(vw["routing_rows"], vw["routing_pairs"], nq, nq * cfg["n_probe"], d)
    c, cb = _least(vw["incluster_rows"], vw["incluster_pairs"], nq, nq * cfg["k"], d)
    print(f"verify_roofline: routing least {r * 1e3:.4f} ms ({rb}), in-cluster least "
          f"{c * 1e3:.4f} ms ({cb}), kernel device {dev_s * 1e3:.4f} ms over "
          f"{vw['batches']} batches; {vw}", file=sys.stderr)
    return 100.0 * (r + c) / dev_s
