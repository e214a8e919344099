"""Quickstart (the port of ``examples/quickstart.py``): build a LIDER index
over a corpus and search it.

    PYTHONPATH=src python examples/quickstart_torch.py [--n 20000]               # on the card
    PYTHONPATH=src python examples/quickstart_torch.py [--n 20000] --device cpu  # on the CPU

Builds the two-layer learned index (k-means -> centroids retriever ->
in-cluster retrievers), runs batched ANN queries, and reports recall@10 and
AQT against exact (Flat) search. The JAX example wraps its search in
``jax.jit``; here ``search_lider``'s entries are the compiled part: on the
card the first call runs once and captures a CUDA graph, and the timed call
replays it. Without ``--device cpu`` it raises where there is no card.
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import torch

from repro_torch.core import lider
from repro_torch.core.baselines import flat_search
from repro_torch.core.utils import recall_at_k
from repro_torch.data import synthetic
from repro_torch.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None, help="cpu for the CPU; default the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"corpus: {args.n} x {args.dim} clustered embeddings (synthetic)")
    corpus = synthetic.retrieval_corpus(0, args.n, args.dim, device=dev)
    queries, _ = synthetic.retrieval_queries(1, corpus, args.queries)

    cfg = lider.LiderConfig(
        n_clusters=max(16, args.n // 1000),
        n_probe=20,
        n_arrays=10,
        n_leaves=5,
        kmeans_iters=10,
    )
    t0 = time.time()
    index = lider.build_lider(0, corpus, cfg, device=dev)
    _sync(dev)
    print(f"build: {time.time()-t0:.1f}s "
          f"(c={cfg.n_clusters}, capacity={index.capacity}, H={cfg.n_arrays})")

    search = lambda q: lider.search_lider(index, q, k=args.k, n_probe=20, r0=8)  # noqa: E731
    search(queries)  # the first call of this signature: runs, then is captured
    _sync(dev)
    t0 = time.time()
    out = search(queries)
    _sync(dev)
    aqt = (time.time() - t0) / args.queries
    gt = flat_search(corpus, queries, k=args.k)
    rec = float(recall_at_k(out.ids, gt.ids))
    print(f"LIDER: recall@{args.k} vs Flat = {rec:.4f}, AQT = {aqt*1e3:.3f} ms")

    refined = lider.search_lider(index, queries, k=args.k, n_probe=20, r0=8, refine=True)
    rec_refined = float(recall_at_k(refined.ids, gt.ids))
    print(f"LIDER(+last-mile refine): recall@{args.k} = {rec_refined:.4f}")
    return {"recall": rec, "recall_refined": rec_refined, "aqt_s": aqt,
            "device": str(dev), "query_path_cache_size": lider.query_path_cache_size()}


if __name__ == "__main__":
    main()
