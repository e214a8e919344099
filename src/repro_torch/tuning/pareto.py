"""Pareto autotuner: sweep the speed-quality knobs, pick an operating point.

The port of the JAX package's ``tuning/pareto.py``. A fixed ``n_probe``
pays the worst-case candidate cost for every query; ``prune_margin`` masks
probes whose routing score trails the query's best. This module closes the
loop:

1. **sweep** ``(n_probe, r0, prune_margin, refine, rescore_factor,
   block_q, sketch_factor)`` on held-out queries over a built index,
   measuring AQT, recall@k, MRR@10 and the pruned-probe fraction per
   operating point; the CLI also sweeps ``--storage-dtypes`` (one index per
   dtype) and tags every point with the bank it ran against;
2. **pareto_frontier** keeps the non-dominated points (min AQT, max recall)
   across all storage dtypes;
3. **select_operating_point** returns the cheapest point meeting a recall
   target (what ``launch.serve --recall-target`` serves), or walks the
   frontier by a load signal; **degradation_ladder** materialises that
   walk as the serving engine's ``DegradePolicy.ladder``.

The CLI writes ``BENCH_torch_tradeoff.json`` and exits non-zero when the
frontier holds a point strictly dominated by a fixed-``n_probe`` baseline.

AQT accounting: on the card the ``fused_verify`` kernel skips every fully
invalid block of a pruned probe, as the TPU kernel does, so ``aqt_s`` is
the measured wall AQT (``aqt_metric`` "measured_wall"). On the CPU the
plain version cannot skip work, so ``aqt_s`` is the cost model ``route +
(full - route) * live_fraction`` built from two measured walls
(routing-only and the full unpruned search at the same ``n_probe``);
both walls land in the JSON. Timing synchronises the device where the JAX
package calls ``block_until_ready``.

The JAX package's ``block_c`` knob (the Pallas kernels' candidate block)
has no counterpart: the CUDA kernels choose their own split.

Usage:
    PYTHONPATH=src python -m repro_torch.tuning.pareto [--smoke]
        [--out BENCH_torch_tradeoff.json] [--recall-target 0.95]
        [--device cpu] ...
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Sequence

import numpy as np
import torch

from ..core import lider as lider_lib
from ..core.utils import mrr_at_10, recall_at_k


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One point of the speed-quality control plane.

    ``rescore_factor`` only affects quantized (int8/int4) indexes (k' =
    factor * k provisional candidates exactly rescored); ``block_q``
    switches the first pass to the cluster-major schedule with that many
    query slots per cluster tile (None: per query; quantized banks only);
    ``sketch_factor`` turns on the 1-bit pre-filter keeping ``sketch_factor
    * k'`` survivors ahead of the code pass (None: no pre-filter;
    quantized banks only).
    """

    n_probe: int
    r0: int = 4
    prune_margin: float | None = None
    refine: bool = False
    rescore_factor: int = 4
    block_q: int | None = None
    sketch_factor: int | None = None

    @property
    def adaptive(self) -> bool:
        return self.prune_margin is not None

    def search_kwargs(self) -> dict:
        return dict(
            n_probe=self.n_probe,
            r0=self.r0,
            refine=self.refine,
            prune_margin=self.prune_margin,
            rescore_factor=self.rescore_factor,
            block_q=self.block_q,
            sketch_factor=self.sketch_factor,
        )

    def label(self) -> str:
        tag = f"probe{self.n_probe}/r{self.r0}"
        if self.refine:
            tag += "/refine"
        if self.adaptive:
            tag += f"/margin{self.prune_margin:g}"
        if self.rescore_factor != 4:
            tag += f"/rescore{self.rescore_factor}"
        if self.block_q is not None:
            tag += f"/bq{self.block_q}"
        if self.sketch_factor is not None:
            tag += f"/sk{self.sketch_factor}"
        return tag


@dataclasses.dataclass(frozen=True)
class SweepResult:
    point: OperatingPoint
    aqt_s: float  # frontier metric (measured on the card, modeled on the CPU)
    wall_aqt_s: float  # wall AQT measured here, pruning applied
    wall_route_s: float  # routing-only wall AQT (model input)
    wall_full_s: float  # unpruned wall AQT at the same n_probe (model input)
    recall: float
    mrr10: float
    pruned_fraction: float
    storage_dtype: str = "float32"  # bank storage the point ran against
    # Which tier held the rescore table, and the measured host fetch time
    # per query (the provisional rows to the host + the gather; 0.0 on the
    # device tier).
    rescore_tier: str = "device"
    host_fetch_s: float = 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(d.pop("point"))
        d["adaptive"] = self.point.adaptive
        return d


def default_grid(
    n_probes: Sequence[int] = (2, 5, 10, 20, 40),
    margins: Sequence[float] = (0.02, 0.05, 0.1, 0.2),
    r0: int = 4,
    refine: bool = False,
    rescore_factors: Sequence[int] = (4,),
    block_qs: Sequence[int | None] = (None,),
    sketch_factors: Sequence[int | None] = (None,),
) -> list[OperatingPoint]:
    """Fixed baselines (margin=None) plus adaptive variants per n_probe,
    each crossed with the rescore depths, block_q widths and sketch
    factors given (the defaults add nothing)."""
    fixed = [
        OperatingPoint(p, r0, None, refine, rf, bq, sf)
        for p in n_probes
        for rf in rescore_factors
        for bq in block_qs
        for sf in sketch_factors
    ]
    adaptive = [
        OperatingPoint(p, r0, m, refine, rf, bq, sf)
        for p in n_probes
        if p > 1  # pruning a single probe can only be a no-op
        for m in margins
        for rf in rescore_factors
        for bq in block_qs
        for sf in sketch_factors
    ]
    return fixed + adaptive


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, queries: torch.Tensor, repeats: int) -> float:
    """Wall seconds per query of ``fn`` (the first call, which builds and
    warms, excluded); the device is synchronised before the clock stops,
    so every output ``fn`` launched is counted."""
    fn(queries)
    _sync(queries.device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(queries)
    _sync(queries.device)
    return (time.perf_counter() - t0) / (repeats * queries.shape[0])


def sweep(
    params,
    queries,
    gt_ids,
    grid: Sequence[OperatingPoint],
    *,
    k: int,
    relevant=None,
    repeats: int = 3,
) -> list[SweepResult]:
    """Measure every operating point on the held-out ``queries``.

    ``gt_ids``: exact top-k ids (Flat search) for recall@k; ``relevant``:
    optional (B,) known-relevant ids for MRR@10. Routing-only and unpruned
    walls are measured once per (n_probe, r0, refine, rescore_factor,
    block_q, sketch_factor) and shared by that combination's margins.
    """
    queries = torch.as_tensor(queries, dtype=torch.float32, device=params.device)
    gt_ids = torch.as_tensor(gt_ids, device=params.device)
    on_card = params.device.type == "cuda"
    storage_dtype = params.bank.storage_dtype
    rescore_tier = params.bank.rescore_tier
    base_walls: dict[tuple, tuple[float, float]] = {}
    host_fetch_walls: dict[tuple, float] = {}
    results = []
    for point in grid:
        base_key = (
            point.n_probe, point.r0, point.refine, point.rescore_factor,
            point.block_q, point.sketch_factor,
        )
        if base_key not in base_walls:
            route = lambda q, p=point: lider_lib.route_queries(params, q, n_probe=p.n_probe)
            full = lambda q, p=point: lider_lib.search_lider(
                params, q, k=k, n_probe=p.n_probe, r0=p.r0, refine=p.refine,
                rescore_factor=p.rescore_factor, block_q=p.block_q,
                sketch_factor=p.sketch_factor,
            )
            base_walls[base_key] = (
                _time_fn(route, queries, repeats),
                _time_fn(full, queries, repeats),
            )
        wall_route, wall_full = base_walls[base_key]

        def run(q, p=point):
            return lider_lib.search_lider(params, q, k=k, with_stats=True, **p.search_kwargs())

        out, pruned = run(queries)
        pruned_frac = float(pruned.to(torch.float32).mean())
        # A fixed point's pruned search IS the base full search (margin=None
        # masks nothing): reuse its wall instead of timing it twice.
        wall = _time_fn(lambda q: run(q)[0], queries, repeats) if point.adaptive else wall_full
        if on_card:
            aqt = wall  # the kernel skips pruned blocks: the wall is the cost
        else:
            live = 1.0 - pruned_frac
            aqt = wall_route + max(wall_full - wall_route, 0.0) * live
        host_fetch_s = 0.0
        if rescore_tier == "host":
            # The measured fetch of the tiered pipeline at this point: the
            # provisional rows to the host and the gather (shared across
            # margins: pruning does not change k').
            fetch_key = (point.n_probe, point.rescore_factor, point.block_q, point.sketch_factor)
            if fetch_key not in host_fetch_walls:
                stage1_kwargs = dict(
                    k=k, n_probe=point.n_probe, r0=point.r0, refine=point.refine,
                    rescore_factor=point.rescore_factor, sketch_factor=point.sketch_factor,
                )
                if point.block_q is None:
                    prov, _ = lider_lib.host_first_pass(params, queries, **stage1_kwargs)
                else:
                    prov, _ = lider_lib.host_first_pass_cluster_major(
                        params, queries, block_q=point.block_q, **stage1_kwargs
                    )
                _sync(queries.device)
                t0 = time.perf_counter()
                for _ in range(repeats):
                    lider_lib.host_fetch(params, prov.ids)
                host_fetch_walls[fetch_key] = (
                    time.perf_counter() - t0
                ) / (repeats * queries.shape[0])
            host_fetch_s = host_fetch_walls[fetch_key]
        results.append(
            SweepResult(
                point=point,
                aqt_s=aqt,
                wall_aqt_s=wall,
                wall_route_s=wall_route,
                wall_full_s=wall_full,
                recall=float(recall_at_k(out.ids, gt_ids)),
                mrr10=(mrr_at_10(out.ids.cpu(), torch.as_tensor(relevant).cpu())
                       if relevant is not None else -1.0),
                pruned_fraction=pruned_frac,
                storage_dtype=storage_dtype,
                rescore_tier=rescore_tier,
                host_fetch_s=host_fetch_s,
            )
        )
    return results


def _dominates(a: SweepResult, b: SweepResult) -> bool:
    """a weakly better on both axes, strictly better on at least one."""
    ge = a.recall >= b.recall and a.aqt_s <= b.aqt_s
    return ge and (a.recall > b.recall or a.aqt_s < b.aqt_s)


def pareto_frontier(results: Sequence[SweepResult]) -> list[SweepResult]:
    """Non-dominated subset (min AQT, max recall), sorted by AQT, over ALL
    swept points, fixed baselines included."""
    front = [r for r in results if not any(_dominates(o, r) for o in results if o is not r)]
    return sorted(front, key=lambda r: r.aqt_s)


def select_operating_point(
    results: Sequence[SweepResult],
    recall_target: float,
    load_signal: float | None = None,
) -> SweepResult:
    """Pick the operating point for one dispatch.

    Offline (``load_signal=None``): the cheapest point meeting the recall
    target; the highest-recall point if none does.

    Online (``load_signal`` in [0, 1], from
    ``serving.Scheduler.load_signal``): load 0 is the nominal
    (recall-target) point; rising load walks toward cheaper frontier
    points, reaching the cheapest at load 1, every point on the walk a
    frontier point.
    """
    meeting = [r for r in results if r.recall >= recall_target]
    nominal = (
        min(meeting, key=lambda r: r.aqt_s)
        if meeting
        else max(results, key=lambda r: (r.recall, -r.aqt_s))
    )
    if load_signal is None:
        return nominal
    load = min(max(float(load_signal), 0.0), 1.0)
    # Walk: nominal first, then strictly cheaper frontier points ordered
    # best-recall first (the chain degradation_ladder materialises).
    chain = [nominal] + sorted(
        (r for r in pareto_frontier(results) if r.aqt_s < nominal.aqt_s),
        key=lambda r: -r.recall,
    )
    return chain[int(round(load * (len(chain) - 1)))]


def degradation_ladder(
    results: Sequence[SweepResult],
    *,
    nominal: SweepResult | None = None,
    max_rungs: int = 3,
) -> list[dict]:
    """Operating-point rungs for the serving degradation ladder
    (``serving.DegradePolicy.ladder``).

    Walks the Pareto frontier downward from the nominal point: each rung is
    strictly cheaper than the last, best recall first, at most
    ``max_rungs`` (evenly spaced when there are more). Each rung dict holds
    the search-knob overrides the engine applies plus the swept
    ``expected_recall``, which the engine ignores.
    """
    front = pareto_frontier(results)
    if nominal is None:
        nominal = front[-1] if front else None
    if nominal is None:
        return []
    cheaper = [r for r in front if r.aqt_s < nominal.aqt_s]
    cheaper.sort(key=lambda r: -r.recall)  # step down quality gradually
    if len(cheaper) > max_rungs:
        idx = np.linspace(0, len(cheaper) - 1, max_rungs).round().astype(int)
        cheaper = [cheaper[i] for i in dict.fromkeys(idx.tolist())]
    rungs = []
    for r in cheaper:
        rung = r.point.search_kwargs()
        rung["expected_recall"] = r.recall
        rungs.append(rung)
    return rungs


def dominated_frontier_points(
    frontier: Sequence[SweepResult], results: Sequence[SweepResult]
) -> list[tuple[SweepResult, SweepResult]]:
    """(frontier point, fixed baseline that strictly dominates it) pairs.
    Non-empty means adaptivity made the trade-off worse somewhere."""
    fixed = [r for r in results if not r.point.adaptive]
    bad = []
    for p in frontier:
        for f in fixed:
            if f.recall >= p.recall and f.aqt_s < p.aqt_s:
                bad.append((p, f))
                break
    return bad


def adaptive_beats_fixed(results: Sequence[SweepResult]) -> bool:
    """Is there an adaptive point cheaper than every fixed config of
    equal-or-better recall?"""
    fixed = [r for r in results if not r.point.adaptive]
    for a in results:
        if not a.point.adaptive:
            continue
        rivals = [f for f in fixed if f.recall >= a.recall]
        if all(a.aqt_s < f.aqt_s for f in rivals):
            return True
    return False


def make_report(
    results: Sequence[SweepResult],
    *,
    k: int,
    n_queries: int,
    recall_target: float | None = None,
    device: str = "cuda",
) -> dict:
    """Frontier + checks + selection over already-swept results, which may
    span several indexes (one per storage dtype); ``device`` is the device
    type the sweep ran on, which sets ``aqt_metric``."""
    results = list(results)
    frontier = pareto_frontier(results)
    frontier_set = {id(r) for r in frontier}
    report = {
        "backend": device,
        "aqt_metric": "measured_wall" if device == "cuda" else "modeled_from_measured_walls",
        "k": k,
        "n_queries": n_queries,
        "storage_dtypes": sorted({r.storage_dtype for r in results}),
        "rescore_tiers": sorted({r.rescore_tier for r in results}),
        "points": [{**r.to_json(), "on_frontier": id(r) in frontier_set} for r in results],
        "frontier": [r.to_json() for r in frontier],
        "checks": {
            "frontier_not_dominated_by_fixed": not dominated_frontier_points(frontier, results),
            "adaptive_beats_fixed_at_equal_or_better_recall": adaptive_beats_fixed(results),
        },
    }
    if recall_target is not None:
        sel = select_operating_point(results, recall_target)
        report["recall_target"] = recall_target
        report["selected"] = {**sel.to_json(), "meets_target": sel.recall >= recall_target}
    return report


def tune(
    params,
    queries,
    gt_ids,
    *,
    k: int,
    grid: Sequence[OperatingPoint] | None = None,
    recall_target: float | None = None,
    relevant=None,
    repeats: int = 3,
) -> dict:
    """Sweep + frontier + selection, as one JSON-ready report dict."""
    grid = list(grid) if grid is not None else default_grid()
    results = sweep(params, queries, gt_ids, grid, k=k, relevant=relevant, repeats=repeats)
    return make_report(
        results, k=k, n_queries=int(queries.shape[0]), recall_target=recall_target,
        device=params.device.type,
    )


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="small corpus + coarse grid")
    ap.add_argument("--out", default="BENCH_torch_tradeoff.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the plain versions)")
    ap.add_argument("--corpus-size", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--n-clusters", type=int, default=None,
                    help="default: corpus_size // 1000 (>= 16)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--recall-target", type=float, default=0.9)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--n-probes", type=int, nargs="+", default=None)
    ap.add_argument("--margins", type=float, nargs="+", default=None)
    ap.add_argument("--storage-dtypes", nargs="+", default=["float32"],
                    choices=["float32", "bfloat16", "int8", "int4"],
                    help="build + sweep one index per storage dtype; the frontier spans all")
    ap.add_argument("--rescore-factors", type=int, nargs="+", default=None,
                    help="k' = factor*k exact-rescore depths to sweep (quantized banks)")
    ap.add_argument("--rescore-tiers", nargs="+", default=["device"], choices=["device", "host"],
                    help="tiers of the quantized banks' rescore table; every quantized point is "
                    "swept per tier (host is skipped for float banks)")
    ap.add_argument("--block-qs", type=int, nargs="+", default=None,
                    help="cluster-major query-tile widths to sweep IN ADDITION to the per-query "
                    "schedule (quantized banks only)")
    ap.add_argument("--sketch-factors", type=int, nargs="+", default=None,
                    help="1-bit pre-filter survivor multiples to sweep IN ADDITION to the "
                    "unfiltered pass (quantized banks only)")
    ap.add_argument("--no-check", action="store_true",
                    help="report only; do not exit non-zero when a check fails")
    args = ap.parse_args(argv)
    if args.smoke:
        args.corpus_size = min(args.corpus_size, 8_000)
        args.dim = min(args.dim, 32)
        args.queries = min(args.queries, 64)
        args.repeats = min(args.repeats, 2)

    from ..core.baselines import flat_search
    from ..data import synthetic
    from ..device import resolve_device

    device = resolve_device(args.device)
    corpus = synthetic.retrieval_corpus(0, args.corpus_size, args.dim, device=device)
    queries, relevant = synthetic.retrieval_queries(1, corpus, args.queries)
    gt = flat_search(corpus, queries, k=args.k)

    n_clusters = args.n_clusters or max(16, args.corpus_size // 1000)
    n_probes = tuple(args.n_probes) if args.n_probes else (
        (2, 4, 8, 16) if args.smoke else (2, 5, 10, 20, 40)
    )
    n_probes = tuple(p for p in n_probes if p <= n_clusters)
    margins = tuple(args.margins) if args.margins else (
        (0.05, 0.1, 0.2) if args.smoke else (0.02, 0.05, 0.1, 0.2)
    )
    block_qs = (None, *args.block_qs) if args.block_qs else (None,)
    sketch_factors = (None, *args.sketch_factors) if args.sketch_factors else (None,)

    results = []
    for sd in args.storage_dtypes:
        cfg = lider_lib.LiderConfig(
            n_clusters=n_clusters, n_arrays=4, n_leaves=4, kmeans_iters=10, storage_dtype=sd,
        )
        t0 = time.time()
        params = lider_lib.build_lider(0, corpus, cfg, device=device)
        print(f"[pareto] built n={args.corpus_size} c={n_clusters} storage={sd} in "
              f"{time.time() - t0:.1f}s")
        quantized = sd in ("int8", "int4")
        rescore_factors = (
            (tuple(args.rescore_factors) if args.rescore_factors else (2, 4)) if quantized else (4,)
        )
        grid = default_grid(
            n_probes=n_probes, margins=margins, rescore_factors=rescore_factors,
            block_qs=block_qs if quantized else (None,),
            sketch_factors=sketch_factors if quantized else (None,),
        )
        for tier in args.rescore_tiers:
            if tier == "host" and not quantized:
                continue  # float banks have no rescore table to move
            p_t = params if tier == "device" else lider_lib.set_rescore_tier(params, "host")
            results.extend(sweep(p_t, queries, gt.ids, grid, k=args.k, relevant=relevant,
                                 repeats=args.repeats))

    report = make_report(results, k=args.k, n_queries=int(queries.shape[0]),
                         recall_target=args.recall_target, device=device.type)
    report["build"] = {
        "corpus_size": args.corpus_size, "dim": args.dim, "n_clusters": n_clusters,
        "storage_dtypes": args.storage_dtypes,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)

    for p in report["points"]:
        star = "*" if p["on_frontier"] else " "
        kind = "adapt" if p["adaptive"] else "fixed"
        fetch = f" fetch={p['host_fetch_s'] * 1e6:.1f}us" if p["rescore_tier"] == "host" else ""
        margin = p["prune_margin"] if p["prune_margin"] is not None else "-"
        sketch = p["sketch_factor"] if p["sketch_factor"] is not None else "-"
        print(
            f"[pareto]{star} {kind} {p['storage_dtype']:>8}/{p['rescore_tier']} "
            f"probe={p['n_probe']:3d} margin={margin:>5} rescore={p['rescore_factor']} "
            f"sketch={sketch:>2} aqt={p['aqt_s'] * 1e6:9.1f}us recall@{args.k}={p['recall']:.4f} "
            f"mrr10={p['mrr10']:.4f} pruned={p['pruned_fraction']:.2%}{fetch}"
        )
    sel = report.get("selected")
    if sel:
        sel_point = OperatingPoint(
            sel["n_probe"], sel["r0"], sel["prune_margin"], sel["refine"],
            sel["rescore_factor"], sel["block_q"], sel["sketch_factor"],
        )
        print(
            f"[pareto] operating point for recall>={args.recall_target}: "
            f"{sel['storage_dtype']}/{sel_point.label()} (aqt={sel['aqt_s'] * 1e6:.1f}us "
            f"recall={sel['recall']:.4f}, meets_target={sel['meets_target']})"
        )
    checks = report["checks"]
    print(f"[pareto] checks: {checks} -> {args.out}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed and not args.no_check:
        raise SystemExit(f"speed-quality regression, failed checks: {failed}")


if __name__ == "__main__":
    main()
