"""Serving launcher: build (or load) a LIDER or baseline index over a corpus
and serve batched queries, optionally with updates mixed into the traffic.

    python -m repro_torch.launch.serve --backend lider --corpus-size 100000 --queries 1024

The port of the JAX package's ``launch/serve.py``, with every flag of it
but two: ``--use-fused`` and ``--block-c`` choose between the Pallas
kernels and their reference and set the Pallas kernels' candidate block,
and the port has neither choice: ``kernels.ops`` runs the CUDA kernels on
the card and their plain versions on the CPU, and the kernels size their
own blocks. ``--device`` (default: the CUDA device; ``cpu`` runs every
kernel's plain version) places the corpus, the index and the queries; with
no card and no ``--device cpu`` the launcher raises.

Index lifecycle (LIDER only):

- ``--load-index DIR`` serves a checkpointed index (either package's save);
- ``--save-index DIR`` saves the served index (after updates) on exit;
- ``--update-fraction F`` holds out an F fraction of the corpus, builds on
  the rest, serves half the queries, upserts the holdout between batches
  through ``RetrievalEngine.apply_updates`` (or, with ``--rolling-update``,
  ``RouterControl.apply_updates`` across the replicas), then serves the rest.

Prints the build seconds, the index tiers, the autotuned operating point,
AQT and recall@k against the exact Flat search; ``--stats-json`` writes
them with the engine's and the router's counters. :func:`main` takes the
arguments as a list, so it can run in the caller's process, and returns
that summary as a dict.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Sequence

import numpy as np
import torch

from .. import faults
from ..core import lider as lider_lib
from ..core import update as update_lib
from ..core.baselines import build_ivfpq, build_mplsh, build_pq, build_sklsh, flat_search
from ..core.utils import recall_at_k
from ..data import synthetic
from ..device import resolve_device
from ..serving import (
    DegradePolicy,
    QueryResult,
    QueryRouter,
    RetrievalEngine,
    RouterConfig,
    SchedulerConfig,
    clone_params,
    make_backend,
)
from ..serving import traffic
from ..serving.engine import EngineStats
from ..training import checkpoint

BACKENDS = ["lider", "flat", "pq", "ivfpq", "sklsh", "mplsh"]


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=BACKENDS, default="lider")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, raising without one; 'cpu' "
                    "runs every kernel's plain version)")
    ap.add_argument("--corpus-size", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--n-clusters", type=int, default=64)
    ap.add_argument("--n-probe", type=int, default=8)
    ap.add_argument("--refine", action="store_true")
    ap.add_argument("--prune-margin", type=float, default=None,
                    help="adaptive probe pruning: mask probes scoring more than this margin "
                    "below the per-query best (LIDER only)")
    ap.add_argument("--recall-target", type=float, default=None,
                    help="autotune (n_probe, prune_margin) on held-out queries and serve the "
                    "cheapest operating point meeting this recall@k (LIDER only; overrides "
                    "--n-probe/--prune-margin)")
    ap.add_argument("--storage-dtype", choices=["float32", "bfloat16", "int8", "int4"],
                    default="float32",
                    help="embedding storage dtype of the LIDER bank; int8/int4 add an exact "
                    "rescore of the provisional top-(rescore_factor*k); int4 packs two codes "
                    "per byte")
    ap.add_argument("--rescore-factor", type=int, default=4,
                    help="k' = rescore_factor * k provisional candidates exactly rescored on "
                    "quantized (int8/int4) banks (LIDER only)")
    ap.add_argument("--rescore-tier", choices=["device", "host"], default=None,
                    help="where the quantized bank's float32 rescore table lives: device "
                    "(next to the codes) or host (host memory; the engine pipelines the "
                    "fetch and rescore stages). Default: device on build, the saved tier on "
                    "--load-index")
    ap.add_argument("--block-q", type=int, default=None,
                    help="cluster-major query-tile width: queries probing the same cluster "
                    "share one read of its rows (quantized banks only). Default: per query")
    ap.add_argument("--sketch-factor", type=int, default=None,
                    help="1-bit Hamming pre-filter ahead of the quantized first pass, keeping "
                    "sketch_factor * k' survivor rows per query (quantized banks only)")
    ap.add_argument("--embeddings", default=None, help=".npy drop-in corpus")
    ap.add_argument("--save-index", default=None, metavar="DIR",
                    help="save the (post-update) LIDER index before exit")
    ap.add_argument("--load-index", default=None, metavar="DIR",
                    help="serve a checkpointed LIDER index instead of building")
    ap.add_argument("--update-fraction", type=float, default=0.0,
                    help="hold out this corpus fraction and upsert it mid-traffic (LIDER only)")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="write engine stats + recall + per-tier index bytes as JSON")
    ap.add_argument("--fault-plan", default=None, metavar="JSON",
                    help="a faults.FaultPlan JSON file (or inline JSON object) injected into "
                    "drain/apply_updates: the engine retries, degrades or rolls back")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request answer deadline driving the engine's degradation "
                    "controller and deadline-miss accounting")
    ap.add_argument("--arrival", choices=["closed", "zipf", "burst"], default="closed",
                    help="traffic: closed (submit all, drain), zipf (open-loop Poisson "
                    "arrivals, Zipf-popular queries) or burst (zipf + high-rate episodes)")
    ap.add_argument("--arrival-rate", type=float, default=None, metavar="QPS",
                    help="open-loop mean arrival rate; default: 2x the measured warm "
                    "full-batch throughput")
    ap.add_argument("--tenants", type=int, default=1,
                    help="number of tenants, spread across per-tenant weighted-fair queues")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request latency SLO (ms): drives the scheduler's load signal, "
                    "dynamic batch-size cap and, with a ladder, frontier navigation")
    ap.add_argument("--cache-size", type=int, default=0,
                    help="result-cache capacity (entries); hits are bit-identical to a fresh "
                    "search and invalidated on apply_updates")
    ap.add_argument("--dynamic-batch", action="store_true",
                    help="size each dispatch from the pre-warmed pow2 batch ladder instead of "
                    "always padding to --batch-size")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a health-checked QueryRouter over this many replica "
                    "engines (device leaves shared, host stores copied) instead of one engine")
    ap.add_argument("--hedge-quantile", type=float, default=0.95,
                    help="router hedging deadline as a quantile of recent batch latencies; "
                    "values outside (0, 1) disable hedging")
    ap.add_argument("--rolling-update", action="store_true",
                    help="apply the --update-fraction upsert as a rolling update "
                    "(RouterControl.apply_updates): replicas drain and update one at a time "
                    "(needs --replicas >= 2)")
    args = ap.parse_args(argv)
    check_args(args)
    return args


def check_args(args: argparse.Namespace) -> None:
    quantized = args.storage_dtype in ("int8", "int4")
    lifecycle = args.save_index or args.load_index or args.update_fraction > 0
    if lifecycle and args.backend != "lider":
        raise SystemExit("--save-index/--load-index/--update-fraction need --backend lider")
    if (args.prune_margin is not None or args.recall_target is not None) and args.backend != "lider":
        raise SystemExit("--prune-margin/--recall-target need --backend lider")
    if args.rescore_tier is not None and args.backend != "lider":
        raise SystemExit("--rescore-tier needs --backend lider")
    # A loaded checkpoint carries its own storage dtype (load_index checks
    # the tier against it), so the dtype checks are for builds only.
    if args.rescore_tier == "host" and not quantized and not args.load_index:
        raise SystemExit("--rescore-tier host needs --storage-dtype int8/int4")
    for flag, value in (("--block-q", args.block_q), ("--sketch-factor", args.sketch_factor)):
        if value is not None and args.backend != "lider":
            raise SystemExit(f"{flag} needs --backend lider")
        if value is not None and not quantized and not args.load_index:
            raise SystemExit(f"{flag} needs --storage-dtype int8/int4")
    if not 0.0 <= args.update_fraction < 1.0:
        raise SystemExit("--update-fraction must be in [0, 1)")
    if args.tenants < 1:
        raise SystemExit("--tenants must be >= 1")
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.rolling_update and args.replicas < 2:
        raise SystemExit("--rolling-update needs --replicas >= 2")


def build_index(args, embs, base_embs, device):
    """The backend's index over the corpus (LIDER over ``base_embs``, the
    corpus less the held-out rows), built on ``device`` from seed 0, or
    loaded."""
    gen = torch.Generator(device=device).manual_seed(0)
    if args.backend == "lider":
        if args.load_index:
            return checkpoint.load_index(args.load_index, device=device,
                                         rescore_tier=args.rescore_tier)
        cfg = lider_lib.LiderConfig(
            n_clusters=args.n_clusters, n_probe=args.n_probe, refine=args.refine,
            storage_dtype=args.storage_dtype, rescore_factor=args.rescore_factor,
            rescore_tier=args.rescore_tier or "device",
        )
        index, stats = lider_lib.build_lider(0, base_embs, cfg, return_stats=True, device=device)
        if stats.n_dropped:
            print(f"[serve] WARNING: capacity overflow dropped {stats.n_dropped} passages at build")
        return index
    builders = {"pq": build_pq, "ivfpq": build_ivfpq, "sklsh": build_sklsh, "mplsh": build_mplsh}
    return builders[args.backend](gen, embs) if args.backend in builders else None


def autotune(args, index, base_embs):
    """The cheapest swept point meeting ``--recall-target`` on 128
    held-out queries, with the rescore, block_q and sketch knobs the
    engine will serve."""
    from ..tuning import pareto as pareto_lib

    held_q, _ = synthetic.retrieval_queries(2, base_embs, 128)
    held_gt = flat_search(base_embs, held_q, k=args.k)
    grid = pareto_lib.default_grid(
        n_probes=tuple(p for p in (2, 4, 8, 16, 32) if p <= args.n_clusters),
        refine=args.refine,
        rescore_factors=(args.rescore_factor,),
        block_qs=(args.block_q,),
        sketch_factors=(args.sketch_factor,),
    )
    t0 = time.time()
    results = pareto_lib.sweep(index, held_q, held_gt.ids, grid, k=args.k, repeats=2)
    sel = pareto_lib.select_operating_point(results, args.recall_target)
    print(
        f"[serve] autotuned operating point for recall@{args.k}>={args.recall_target}: "
        f"{sel.point.label()} (held-out recall={sel.recall:.4f}, aqt={sel.aqt_s * 1e6:.1f}us, "
        f"{time.time() - t0:.1f}s sweep)"
    )
    return sel


def merged_stats(engines) -> EngineStats:
    """Fleet-wide engine accounting: counters summed, the bounded recent
    windows merged (router-level counters live on ``router.stats``)."""
    if len(engines) == 1:
        return engines[0].stats
    stats = EngineStats()
    for eng in engines:
        for fld in dataclasses.fields(EngineStats):
            v = getattr(eng.stats, fld.name)
            cur = getattr(stats, fld.name)
            if hasattr(cur, "extend"):
                cur.extend(v)
            else:
                setattr(stats, fld.name, cur + v)
    return stats


def main(argv: Sequence[str] | None = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)

    if args.embeddings:
        embs = synthetic.load_embeddings(args.embeddings, device=device)
    else:
        embs = synthetic.retrieval_corpus(0, args.corpus_size, args.dim, device=device)
    queries, _ = synthetic.retrieval_queries(1, embs, args.queries)

    n_held = int(embs.shape[0] * args.update_fraction)
    base_embs, held_embs = (embs[:-n_held], embs[-n_held:]) if n_held else (embs, None)

    t0 = time.time()
    index = build_index(args, embs, base_embs, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.time() - t0
    print(f"[serve] backend={args.backend} {'loaded' if args.load_index else 'built'} in "
          f"{build_s:.1f}s on {device}")
    tier_bytes = None
    if args.backend == "lider":
        tier_bytes = index.bank.nbytes_by_tier()
        print(
            f"[serve] index tiers: rescore_tier={index.bank.rescore_tier} "
            f"device={tier_bytes['device'] / 2**20:.1f} MiB host={tier_bytes['host'] / 2**20:.1f} MiB"
        )

    # Operating point: the flags, or autotuned for a recall target.
    n_probe, prune_margin, selected = args.n_probe, args.prune_margin, None
    if args.recall_target is not None:
        selected = autotune(args, index, base_embs)
        n_probe, prune_margin = selected.point.n_probe, selected.point.prune_margin

    backend_kw = {
        "lider": dict(
            n_probe=n_probe, refine=args.refine, prune_margin=prune_margin,
            rescore_factor=args.rescore_factor, block_q=args.block_q,
            sketch_factor=args.sketch_factor,
        ),
        "ivfpq": dict(n_probe=args.n_probe),
        "mplsh": dict(n_probe=args.n_probe),
    }.get(args.backend, {})
    fault_plan = None
    if args.fault_plan:
        fault_plan = faults.FaultPlan.from_json(args.fault_plan)
        print(f"[serve] fault plan active: {len(fault_plan.specs)} spec(s), seed={fault_plan.seed}")
    policy = DegradePolicy(deadline_s=args.deadline_s)
    sched_cfg = SchedulerConfig(
        dynamic_batch=args.dynamic_batch,
        min_batch=max(1, args.batch_size // 8),
        cache_size=args.cache_size,
        slo_s=args.slo_ms / 1e3 if args.slo_ms is not None else None,
    )

    def build_one_engine(i: int) -> RetrievalEngine:
        if args.backend == "lider":
            # Replica 0 serves the built params; the others a clone (device
            # leaves shared, the host store copied: in-place host-tier
            # updates must not bleed across replica generations).
            return RetrievalEngine(
                make_backend("lider", None, updatable=True, **backend_kw),
                batch_size=args.batch_size, k=args.k, dim=embs.shape[1],
                params=index if i == 0 else clone_params(index),
                policy=policy, fault_plan=fault_plan, scheduler=sched_cfg,
            )
        search = make_backend(args.backend, index, embs, device=device, **backend_kw)
        return RetrievalEngine(
            search, batch_size=args.batch_size, k=args.k, dim=embs.shape[1],
            policy=policy, fault_plan=fault_plan, scheduler=sched_cfg,
        )

    engines = [build_one_engine(i) for i in range(args.replicas)]
    engine = engines[0]
    router = None
    if args.replicas > 1:
        hq = args.hedge_quantile if 0.0 < args.hedge_quantile < 1.0 else None
        router = QueryRouter(
            engines,
            config=RouterConfig(hedge_quantile=hq, deadline_s=args.deadline_s),
            scheduler=sched_cfg,
            fault_plan=fault_plan,
        )
        print(f"[serve] router over {args.replicas} replicas (hedge_quantile={hq})")
    server = router if router is not None else engine
    server.warmup()

    qs = queries.cpu().numpy()
    tenant_of = lambda i: f"tenant{i % args.tenants}"
    got_rows = []  # (query index, answered ids); shed requests excluded

    def apply_holdout_upsert() -> None:
        t0 = time.time()
        up_fn = lambda p: update_lib.upsert(p, held_embs)
        if args.rolling_update:
            # RouterControl drains and updates one replica at a time behind
            # the health mask; the rest of the fleet keeps serving.
            router.control.apply_updates(up_fn, block=True)
            lo, hi = router.generation_window()
            print(
                f"[serve] rolling upsert of {n_held} passages in {time.time() - t0:.3f}s "
                f"({router.stats.n_roll_replicas_updated} replicas updated, "
                f"{router.stats.n_roll_replicas_skipped} skipped, generation_window=[{lo}, {hi}], "
                f"wrong_generation={router.stats.n_wrong_generation})"
            )
            return
        grew = False
        for eng in engines:
            try:
                grew = eng.apply_updates(up_fn)
            except faults.InjectedFault as e:
                # apply_updates rolled the host tier back; the engine serves
                # the old generation. Retry once (the fault schedule moved on).
                print(f"[serve] update failed ({e}); rolled back, retrying")
                grew = eng.apply_updates(up_fn)
        dt = time.time() - t0
        print(
            f"[serve] upserted {n_held} passages in {dt:.3f}s ({n_held / max(dt, 1e-9):.0f}/s), "
            f"generation={engine.generation}, capacity_grew={grew} "
            f"(recompiles={engine.recompiles}, rollbacks={engine.stats.n_update_rollbacks})"
        )

    if args.arrival == "closed":
        # Submit, drain and collect in windows under the results bound: the
        # results map is a bounded FIFO, so queueing a whole large run before
        # collecting would evict the oldest answers mid-drain.
        window = min(4096, engine.max_results)

        def serve_chunk(chunk, base) -> None:
            for start in range(0, len(chunk), window):
                rids = [server.submit(q, tenant=tenant_of(base + start + j))
                        for j, q in enumerate(chunk[start : start + window])]
                while server.pending_requests:
                    server.drain()
                for j, r in enumerate(rids):
                    res = server.result(r)
                    if isinstance(res, QueryResult):
                        got_rows.append((base + start + j, res.ids))

        if held_embs is not None:
            half = len(qs) // 2  # serve half, upsert the holdout, serve the rest
            serve_chunk(qs[:half], 0)
            apply_holdout_upsert()
            serve_chunk(qs[half:], half)
        else:
            serve_chunk(qs, 0)
    else:
        # Open loop: seeded Zipf[+burst] arrivals over the query set as a
        # popularity pool, replayed in real time; with --update-fraction the
        # upsert lands between the two halves of the trace.
        rate = args.arrival_rate
        if rate is None:
            qw = torch.zeros((args.batch_size, embs.shape[1]), dtype=torch.float32, device=device)
            with engine._on_stream():
                t0 = time.perf_counter()
                engine._search(qw)
                engine._wait()
                rate = 2.0 * args.batch_size / (time.perf_counter() - t0)
        trace = traffic.make_trace(seed=3, n_arrivals=len(qs), pool_size=len(qs), mean_rate=rate,
                                   pattern=args.arrival, n_tenants=args.tenants)
        print(f"[serve] open loop: {len(trace)} {args.arrival} arrivals at {rate:.0f} qps across "
              f"{args.tenants} tenant(s)")

        def replay(part) -> None:
            t_base = part[0].t if part else 0.0
            shifted = [dataclasses.replace(a, t=a.t - t_base) for a in part]
            rids = traffic.run_open_loop(server, shifted, qs)
            for a, r in zip(shifted, rids):
                res = server.result(r)
                if isinstance(res, QueryResult):
                    got_rows.append((a.query_idx, res.ids))

        if held_embs is not None:
            half = len(trace) // 2
            replay(trace[:half])
            apply_holdout_upsert()
            replay(trace[half:])
        else:
            replay(trace)
    if router is not None:
        router.close()  # quiesce hedge losers before reading stats
    stats = merged_stats(engines)
    pruned_note = ""
    if stats.n_probes_total:
        per_batch = ", ".join(f"{f:.0%}" for f in list(stats.batch_pruned_fraction)[:8])
        pruned_note = (f", pruned probes {stats.pruned_probe_fraction:.1%} (per batch: {per_batch}"
                       + (", ..." if stats.n_batches > 8 else "") + ")")
    host_note = ""
    if stats.n_host_fetches:
        host_note = (f", host fetch {stats.host_fetch_us / 1e3:.1f} ms total over "
                     f"{stats.n_host_fetches} batches, overlap {stats.overlap_fraction:.0%}")
    print(f"[serve] {stats.n_queries} queries in {stats.total_time_s:.3f}s -> "
          f"AQT={stats.aqt * 1e3:.3f} ms (padding {stats.padding_fraction:.1%}{pruned_note}"
          f"{host_note})")
    if router is not None:
        rs = router.stats
        print(
            f"[serve] router: availability={rs.availability:.4f} hedges={rs.n_hedges} "
            f"(won {rs.n_hedge_wins}) failovers={rs.n_failovers} kills={rs.n_replica_kills} "
            f"wrong_generation={rs.n_wrong_generation} shed={rs.n_shed}"
        )

    if args.save_index:
        path = checkpoint.save_index(args.save_index, engine.params)
        print(f"[serve] index saved -> {path}")

    gt = flat_search(embs, queries, k=args.k)
    got = torch.from_numpy(np.stack([np.asarray(ids) for _, ids in got_rows])).to(device)
    rec = float(recall_at_k(got, gt.ids[torch.tensor([i for i, _ in got_rows], device=device)]))
    print(f"[serve] recall@{args.k} vs Flat = {rec:.4f} ({len(got_rows)} answered)")

    s = stats
    # What was served: a loaded checkpoint's dtype and tier, not the flags.
    served_bank = getattr(engine.params, "bank", None)
    record = {
        "backend": args.backend,
        "device": str(device),
        "storage_dtype": served_bank.storage_dtype if served_bank is not None else args.storage_dtype,
        "rescore_tier": served_bank.rescore_tier if served_bank is not None else None,
        "build_s": build_s,
        "n_queries": s.n_queries,
        "n_batches": s.n_batches,
        "aqt_s": s.aqt,
        "padding_fraction": s.padding_fraction,
        "host_fetch_us": s.host_fetch_us,
        "n_host_fetches": s.n_host_fetches,
        "overlap_fraction": s.overlap_fraction,
        "generation": engine.generation,
        "device_generation": engine.device_generation,
        "host_generation": engine.host_generation,
        "recompiles": engine.recompiles,
        "recall_at_k": rec,
        "n_answered": len(got_rows),
        "k": args.k,
        "block_q": args.block_q,
        "sketch_factor": args.sketch_factor,
        "tier_bytes": tier_bytes,
        "selected": selected.to_json() if selected is not None else None,
        "n_update_rollbacks": s.n_update_rollbacks,
        "n_fetch_retries": s.n_fetch_retries,
        "n_fetch_failures": s.n_fetch_failures,
        "n_degraded": s.n_degraded,
        "n_shed": s.n_shed + (router.stats.n_shed if router is not None else 0),
        "n_deadline_misses": s.n_deadline_misses,
        "n_faults_fired": fault_plan.n_fired if fault_plan is not None else 0,
        # Firings per site, zero-filled over every configured site.
        "fault_sites": (fault_plan.site_counts() if fault_plan is not None
                        else {site: 0 for site in faults.SITES}),
        "arrival": args.arrival,
        "tenants": args.tenants,
        "slo_ms": args.slo_ms,
        "cache_size": args.cache_size,
        "dynamic_batch": args.dynamic_batch,
        "n_cache_hits": s.n_cache_hits,
        "n_cache_misses": s.n_cache_misses,
        "cache_hit_rate": s.cache_hit_rate,
        "n_rung_steps": s.n_rung_steps,
        "batch_size_trace_tail": list(s.batch_size_trace)[-16:],
        "p50_latency_s": s.latency_quantile(0.5),
        "p99_latency_s": s.latency_quantile(0.99),
        "replicas": args.replicas,
        "hedge_quantile": args.hedge_quantile,
        "rolling_update": args.rolling_update,
        "router": router.stats_dict() if router is not None else None,
    }
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(record, f, indent=1)
        print(f"[serve] stats -> {args.stats_json}")
    return record


if __name__ == "__main__":
    main()
