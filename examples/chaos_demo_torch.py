"""Fault-tolerance walkthrough (the port of ``examples/chaos_demo.py``): a
seeded fault plan injects a mid-update crash and a host-fetch outage into a
live serving engine; the update rolls back bit-identically, the outage
batch degrades to a compressed-only answer instead of failing, and serving
continues on the old generation until a clean retry lands.

    PYTHONPATH=src python examples/chaos_demo_torch.py [--n 4000]               # on the card
    PYTHONPATH=src python examples/chaos_demo_torch.py [--n 4000] --device cpu  # on the CPU

On the card the committed update makes new device leaves, so the engine
captures its warmed query-path graphs again on them before serving them.
Without ``--device cpu`` it raises where there is no card.
"""
from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np

from repro_torch import faults
from repro_torch.core import lider, update
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.serving import DegradePolicy, RetrievalEngine, make_backend


def serve(engine, queries):
    rids = [engine.submit(v) for v in queries]
    engine.drain()
    return [engine.result(r) for r in rids]


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None, help="cpu for the CPU; default the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = synthetic.retrieval_corpus(0, args.n, args.dim, device=dev)
    queries, _ = synthetic.retrieval_queries(1, corpus, 32)
    qarr = queries.cpu().numpy()
    base, held = corpus[:-400], corpus[-400:]

    # int8 storage with the rescore table on the host: the tier with the
    # most failure surface (host fetch, in-place lifecycle writes).
    params = lider.build_lider(
        0, base,
        lider.LiderConfig(n_clusters=16, n_probe=4, storage_dtype="int8", rescore_tier="host"),
        device=dev,
    )

    # The schedule is seeded and indexed by per-site call counts, so this
    # demo replays identically every run: the first host write of the next
    # update crashes (after mutating the host table in place!), and fetch
    # calls 2..4 fail, one batch's worth of retries, exhausted.
    plan = faults.FaultPlan(
        [
            faults.FaultSpec("host_write", mode="error", times=(0,)),
            faults.FaultSpec("host_fetch", mode="error", times=(2, 3, 4)),
        ],
        seed=7,
    )
    engine = RetrievalEngine(
        make_backend("lider", None, updatable=True, n_probe=4),
        batch_size=32, k=args.k, dim=args.dim, params=params,
        policy=DegradePolicy(fetch_retries=2, fetch_backoff_s=0.001),
        fault_plan=plan,
    )
    engine.warmup()

    before = serve(engine, qarr)
    print(f"serving generation {engine.generation}: "
          f"top-1 ids {[int(r.ids[0]) for r in before[:6]]} ...")

    # --- mid-update crash -> transactional rollback -----------------------
    try:
        engine.apply_updates(lambda p: update.upsert(p, held))
    except faults.InjectedFault as e:
        print(f"update crashed mid-write ({e}) -> host tier rolled back, "
              f"rollbacks={engine.stats.n_update_rollbacks}")

    after = serve(engine, qarr)
    identical = all(
        np.array_equal(np.asarray(a.ids), np.asarray(b.ids))
        and np.array_equal(np.asarray(a.scores), np.asarray(b.scores))
        for a, b in zip(before, after)
    )
    print(f"post-rollback serving bit-identical to pre-update: {identical}")
    assert identical, "rollback must restore the exact pre-update answers"

    # --- retry the update: the schedule has moved on, it lands cleanly ----
    engine.apply_updates(lambda p: update.upsert(p, held))
    print(f"retried update committed: generation {engine.generation}, "
          f"{engine.params.bank.store.shape} host rows")

    # --- host-fetch outage -> degraded compressed-only answer -------------
    out = serve(engine, qarr)
    n_deg = sum(r.degraded for r in out)
    print(f"fetch outage batch: {engine.stats.n_fetch_retries} retries, "
          f"{engine.stats.n_fetch_failures} exhausted -> {n_deg} queries "
          f"answered compressed-only (degraded=True), drain never raised")

    # --- and the outage is over: full-quality answers again ---------------
    out2 = serve(engine, qarr)
    print(f"next batch back to full quality: degraded="
          f"{any(r.degraded for r in out2)}, "
          f"faults fired in total: {plan.n_fired}")
    return {"rollback_identical": identical, "rollbacks": engine.stats.n_update_rollbacks,
            "generation": engine.generation, "n_degraded": n_deg,
            "fetch_retries": engine.stats.n_fetch_retries,
            "fetch_failures": engine.stats.n_fetch_failures,
            "recovered": not any(r.degraded for r in out2), "faults_fired": plan.n_fired,
            "recompiles": engine.recompiles, "recapture_s": engine.recapture_s,
            "graph_bytes": engine.graph_bytes}


if __name__ == "__main__":
    main()
