"""Batched retrieval serving across index backends (the port of
``examples/serve_retrieval.py``), through the scheduler front end: queued
requests from skewed tenants with Zipf-repeated queries, result caching,
dynamic batch sizing, AQT / latency / quality per backend.

    PYTHONPATH=src python examples/serve_retrieval_torch.py [--n 30000]               # on the card
    PYTHONPATH=src python examples/serve_retrieval_torch.py [--n 30000] --device cpu  # on the CPU

``engine.warmup()`` runs every batch size of the scheduler's ladder once
before serving: on the card that captures the LIDER query path's CUDA
graphs, so no request pays for a first run. Without ``--device cpu`` it
raises where there is no card.
"""
from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import lider
from repro_torch.core.baselines import build_ivfpq, build_mplsh, build_sklsh, flat_search
from repro_torch.core.utils import recall_at_k
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.serving import QueryResult, RetrievalEngine, SchedulerConfig, make_backend
from repro_torch.serving.traffic import zipf_weights


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--arrivals", type=int, default=1024,
                    help="Zipf-skewed requests drawn from the query pool")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--device", default=None, help="cpu for the CPU; default the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = synthetic.retrieval_corpus(0, args.n, args.dim, device=dev)
    queries, _ = synthetic.retrieval_queries(1, corpus, args.queries)
    gt = flat_search(corpus, queries, k=args.k).ids.cpu().numpy()
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731

    backends = {}
    idx = lider.build_lider(
        0, corpus,
        lider.LiderConfig(n_clusters=max(16, args.n // 1000), n_probe=20,
                          n_arrays=10, n_leaves=5, kmeans_iters=10),
        device=dev,
    )
    backends["lider"] = make_backend("lider", idx, n_probe=20, r0=4)
    backends["flat"] = make_backend("flat", None, corpus, device=dev)
    backends["ivfpq"] = make_backend("ivfpq", build_ivfpq(gen(), corpus, kmeans_iters=8), n_probe=20)
    backends["sklsh"] = make_backend("sklsh", build_sklsh(gen(), corpus), corpus)
    backends["mplsh"] = make_backend("mplsh", build_mplsh(gen(), corpus), corpus, n_probe=8)

    # The serving workload: arrivals repeat popular pool queries (Zipf) from
    # three tenants of very different submit rates, the shape the result
    # cache and the weighted-fair queues exist for.
    trng = np.random.default_rng(7)
    qarr = queries.cpu().numpy()
    pool_idx = trng.choice(len(qarr), size=args.arrivals, p=zipf_weights(len(qarr), 1.1))
    tenants = trng.choice(["free", "pro", "enterprise"], size=args.arrivals, p=[0.6, 0.3, 0.1])

    print(f"{'backend':8s} {'AQT(ms)':>9s} {'p99(ms)':>8s} {'recall@10':>10s} "
          f"{'cache':>6s} {'batches':>8s}")
    report = {}
    for name, fn in backends.items():
        engine = RetrievalEngine(
            fn, batch_size=args.batch_size, k=args.k, dim=args.dim,
            scheduler=SchedulerConfig(
                dynamic_batch=True,
                min_batch=max(1, args.batch_size // 8),
                cache_size=4 * len(qarr),
                tenant_weights={"free": 1.0, "pro": 2.0, "enterprise": 4.0},
            ),
        )
        engine.warmup()  # every batch size of the ladder once, off the path
        # Submit/drain/collect in windows: result() pops and the results map
        # is bounded, so collecting right after each drain keeps the
        # engine's memory flat however many arrivals there are.
        rows, idx_rows = [], []
        window = min(4096, engine.max_results)
        for start in range(0, args.arrivals, window):
            sl = slice(start, min(start + window, args.arrivals))
            rids = [engine.submit(qarr[i], tenant=t) for i, t in zip(pool_idx[sl], tenants[sl])]
            engine.drain()
            for i, r in zip(pool_idx[sl], rids):
                res = engine.result(r)
                if isinstance(res, QueryResult):
                    rows.append(np.asarray(res.ids))
                    idx_rows.append(i)
        got = np.stack(rows)
        rec = float(recall_at_k(torch.from_numpy(got[:, :10]), torch.from_numpy(gt[idx_rows, :10])))
        s = engine.stats
        print(f"{name:8s} {s.aqt*1e3:9.3f} "
              f"{s.latency_quantile(0.99)*1e3:8.2f} {rec:10.4f} "
              f"{s.cache_hit_rate:6.0%} {s.n_batches:8d}")
        report[name] = {"answered": len(rows), "recall_at_10": rec, "aqt_s": s.aqt,
                        "p99_s": s.latency_quantile(0.99), "cache_hit_rate": s.cache_hit_rate,
                        "batches": s.n_batches, "graph_bytes": engine.graph_bytes}
    return report


if __name__ == "__main__":
    main()
