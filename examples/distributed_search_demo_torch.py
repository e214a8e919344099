"""Distributed LIDER on a world of ranks: cluster-parallel sharding,
capacity dispatch and the all-gather merge (the port of
``examples/distributed_search_demo.py``).

    PYTHONPATH=src python examples/distributed_search_demo_torch.py               # 4 ranks on the card
    PYTHONPATH=src python examples/distributed_search_demo_torch.py --device cpu  # 8 gloo ranks

On the card the four ranks form a (data=2, model=2) grid; on the CPU eight
gloo ranks form a (data=4, model=2) grid, the JAX demo's mesh. The parent
builds the index, each rank keeps its clusters' shard and searches its
queries, and the answers are held against the single-device search and
against Flat.
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import distributed, lider
from repro_torch.core.baselines import flat_search
from repro_torch.core.utils import recall_at_k
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import mesh

N, DIM, N_QUERIES = 20_000, 64, 128
K, N_PROBE, R0 = 10, 12, 4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_main(world, params, queries, shape):
    """One rank: shard the index, search twice (the second timed)."""
    grid = mesh.make_grid(shape, device=world.device)
    shard = distributed.shard_lider_params(grid, params, ("data",))
    search = distributed.make_sharded_search(
        grid, shard, k=K, n_probe=N_PROBE, r0=R0, capacity_factor=2.0
    )
    queries = distributed.shard_rows(grid, queries, ("model",))  # this rank's block
    search(shard, queries)
    _sync(world.device)
    grid.barrier()
    t0 = time.perf_counter()
    out, dropped = search(shard, queries)
    _sync(world.device)
    dt = time.perf_counter() - t0
    full = distributed.gather_query_shards(grid, out)
    return full.ids.cpu().numpy(), int(dropped), dt


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu for gloo ranks on the CPU; default the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_ranks, shape = (8, (4, 2)) if dev.type == "cpu" else (4, (2, 2))
    backend = mesh.default_backend(n_ranks, dev.type)
    print(f"grid: {dict(zip(mesh.DEFAULT_AXES, shape))} (clusters shard over 'data', "
          f"queries over 'model'; {n_ranks} ranks, {backend})", flush=True)

    corpus = synthetic.retrieval_corpus(0, N, DIM, device=dev)
    queries, _ = synthetic.retrieval_queries(1, corpus, N_QUERIES)
    cfg = lider.LiderConfig(n_clusters=64, n_probe=N_PROBE, n_arrays=6, n_leaves=4, kmeans_iters=10)
    params = lider.build_lider(0, corpus, cfg, device=dev)

    results = mesh.spawn(n_ranks, rank_main, params, queries.cpu(), shape, device=dev,
                         backend=backend)
    ids, dropped, dt = results[0]
    dt = max(r[2] for r in results)

    ref = lider.search_lider(params, queries, k=K, n_probe=N_PROBE, r0=R0)
    gt = flat_search(corpus, queries, k=K)
    out_ids = torch.from_numpy(ids)
    rec = float(recall_at_k(out_ids.to(gt.ids.device), gt.ids))
    rec_ref = float(recall_at_k(ref.ids, gt.ids))
    ref_ids = ref.ids.cpu().numpy()
    overlap = float(np.mean([
        len(set(a[a >= 0]) & set(b[b >= 0])) / max(len(set(a[a >= 0])), 1)
        for a, b in zip(ref_ids, ids)
    ]))
    print(f"distributed search: {dt * 1e3 / N_QUERIES:.3f} ms/query, capacity drops={dropped}")
    print(f"recall@{K} vs Flat: distributed={rec:.4f} single-device={rec_ref:.4f}")
    print(f"distributed == single-device result overlap: {overlap:.4f}")
    return {"recall": rec, "recall_single": rec_ref, "overlap": overlap, "dropped": dropped}


if __name__ == "__main__":
    main()
