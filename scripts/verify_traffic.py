#!/usr/bin/env python3
"""Time the per-query verification kernels of one source tree on two kinds
of candidate traffic at the in-cluster call's shape (B=256, C=80,000,
N=1,048,576, d=768):

- ``windows``: each query's candidates are 20 runs of 4,000 draws over the
  1,024 positions of one cluster (~1,000 distinct rows a run, as a LIDER
  chunk repeats rows), 5% of them invalid;
- ``uniform``: rows drawn uniformly over N, so almost none repeats.

    python3 scripts/verify_traffic.py [TREE]

TREE (default: this checkout) holds the ``src/repro_torch`` that is
imported, so an older commit unpacked elsewhere runs on the same inputs
(made on the card from a fixed seed). Prints the card's name and power
limit, then one JSON line: for each traffic and kernel call, the median of
5 CUDA-event times after a warm-up, and a digest of the ids and scores
(equal across trees for the bit-exact int8 and sketch kernels).
"""
from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def digest(ids: torch.Tensor, scores: torch.Tensor) -> str:
    h = hashlib.sha256(ids.cpu().numpy().tobytes())
    h.update(scores.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]
    if not torch.cuda.is_available():
        print("verify_traffic: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core.utils import l2_normalize
    from repro_torch.kernels import quant
    from repro_torch.kernels.fused_verify import fused_verify, sketch_prefilter

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(11)
    n, b, c, d, run, size = 1_048_576, 256, 80_000, 768, 4_000, 1_024
    embs = l2_normalize(torch.randn((n, d), generator=g, device=dev))
    q = l2_normalize(torch.randn((b, d), generator=g, device=dev))
    codes, scales = quant.quantize_rows(embs)
    sketches = quant.sketch_rows(embs)
    cid = torch.randint(0, n // size, (b, c // run), generator=g, device=dev)
    pos = torch.randint(0, size, (b, c), generator=g, device=dev)
    windows = (cid.repeat_interleave(run, dim=1) * size + pos).to(torch.int32)
    w_out = windows.clone()
    w_out[torch.rand((b, c), generator=g, device=dev) < 0.05] = -1
    uniform = torch.randint(0, n, (b, c), generator=g, device=dev, dtype=torch.int32)
    calls = {
        "float32 k=100": lambda r, o: fused_verify(embs, r, q, k=100, out_ids=o),
        "int8 k=400": lambda r, o: fused_verify(codes, r, q, k=400, out_ids=o, scales=scales,
                                                code_dtype="int8"),
        "sketch k=1600": lambda r, o: sketch_prefilter(sketches, r, q, k=1600, out_ids=o),
    }
    res = {"tree": str(tree)}
    for traffic, (rows, out) in {"windows": (windows, w_out), "uniform": (uniform, uniform)}.items():
        res[traffic] = {
            "distinct_pairs": int(torch.unique(
                (torch.arange(b, device=dev)[:, None] * n + rows.to(torch.int64))[out >= 0]).numel()),
        }
        for name, call in calls.items():
            ids, scores = call(rows, out)
            res[traffic][name] = {"ms": cuda_ms(lambda: call(rows, out)), "digest": digest(ids, scores)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
