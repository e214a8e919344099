#!/usr/bin/env python3
"""Find the highest rate an open-loop cell sustains: build the cell's index
once, then replay its traffic at each rate for ``--seconds`` and print, a
line a rate, the latency quantiles from due time, the p95 of the window's
first and last quarters (a growing backlog shows as the last above the
first) and the rate answered.

    python3 perfbench/sweep.py --workload <open cell> --seed <n> --seconds <s> --rates <r> [<r> ...]

The cell's traffic file then takes four fifths of the highest rate
sustained, as a number.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import pbench  # noqa: E402

pbench.process_settings()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pbench import cell, data, loops  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        cell.log("needs a CUDA device")
        return 2
    from pbench import system

    dev = torch.device("cuda", 0)
    spec = cell.load_spec(args.workload)
    cfg, tr = spec["config"], spec["traffic"]
    corpus = data.retrieval_corpus(args.seed + cell.CORPUS, cfg["corpus_size"], cfg["dim"],
                                   spread=cfg["spread"], device=dev)
    pool = data.retrieval_queries(args.seed + cell.POOL, corpus, tr["pool"],
                                  noise=cfg["query_noise"]).cpu().numpy()
    params, _ = system.build(corpus, cfg, args.seed + cell.BUILD)
    del corpus
    torch.cuda.empty_cache()
    eng = system.engine(params, cfg, tr)
    eng.warmup()
    for rate in args.rates:
        times, qidx, tidx = data.make_trace(
            seed=args.seed + cell.ARRIVALS, n_arrivals=int(rate * args.seconds * 1.2) + 64,
            pool_size=tr["pool"], mean_rate=rate, pattern=tr["pattern"], zipf_a=tr["zipf_a"],
            n_tenants=tr["tenants"])
        due = times < args.seconds
        before = system.engine_counts(eng)
        win = loops.open_loop(eng, pool, times[due], qidx[due],
                              [f"tenant{t}" for t in tidx[due]], keep=set(),
                              answer_of=system.answer_of)
        after = system.engine_counts(eng)
        lat = (win["answer"] - win["due"]) * 1e3
        q = np.array_split(lat, 4)
        n_q = after["n_queries"] - before["n_queries"]
        fill = n_q / max(n_q + after["n_padded"] - before["n_padded"], 1)
        print(json.dumps({
            "rate": rate, "requests": int(lat.size),
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "p95_first_quarter_ms": float(np.percentile(q[0], 95)),
            "p95_last_quarter_ms": float(np.percentile(q[-1], 95)),
            "answered_per_s": float(lat.size / np.nanmax(win["answer"])),
            "batch_fill": fill, "late_submit_p95_ms":
                float(np.percentile((win["submit"] - win["due"]) * 1e3, 95))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
