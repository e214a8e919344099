"""The port's Pareto autotuner (``repro_torch.tuning.pareto``) against the
JAX package's.

- ``pareto_frontier``, ``select_operating_point`` (offline, and online at
  every load signal), ``degradation_ladder``, ``dominated_frontier_points``,
  ``adaptive_beats_fixed`` and ``make_report``'s checks and selection:
  decision for decision equal to JAX's on the same ``SweepResult`` values
  (seeded random sweeps, with ties in recall and in AQT). Exact: the
  decisions are comparisons of the same floats.
- ``sweep`` on a small index on the CPU: the cost model and the bookkeeping
  the JAX sweep keeps (a fixed point's wall is its full wall, the AQT of a
  point is ``route + (full - route) * live``), recall equal to a direct
  ``search_lider``, and the host tier's fetch time measured.
- The CLI at a tiny size writes its report (``BENCH_torch_tradeoff.json``
  by default; here under ``tmp_path``).
"""
import json

import numpy as np
import pytest
import torch

from repro.tuning import pareto as jpareto
from repro_torch.core import lider
from repro_torch.core.baselines import flat_search
from repro_torch.core.utils import recall_at_k
from repro_torch.data import synthetic
from repro_torch.tuning import pareto

OPTIONAL = ("block_q", "sketch_factor")


def _sweeps(seed: int, n: int = 24):
    """The same random sweep in both packages: recall and AQT drawn from a
    few values, so ties occur on both axes."""
    rng = np.random.default_rng(seed)
    out_t, out_j = [], []
    for i in range(n):
        kw = dict(
            n_probe=int(rng.choice([2, 4, 8, 16])),
            r0=4,
            prune_margin=None if rng.random() < 0.4 else float(rng.choice([0.02, 0.05, 0.1])),
            refine=False,
            rescore_factor=int(rng.choice([2, 4])),
            block_q=None if rng.random() < 0.5 else 8,
            sketch_factor=None if rng.random() < 0.5 else 4,
        )
        vals = dict(
            aqt_s=float(rng.choice([1e-5, 2e-5, 3e-5, 5e-5, 8e-5])) * (1 + i % 3),
            wall_aqt_s=1e-5, wall_route_s=1e-6, wall_full_s=2e-5,
            recall=float(rng.choice([0.5, 0.6, 0.7, 0.8, 0.9, 0.95])),
            mrr10=-1.0, pruned_fraction=float(rng.random()),
        )
        out_t.append(pareto.SweepResult(point=pareto.OperatingPoint(**kw), **vals))
        out_j.append(jpareto.SweepResult(point=jpareto.OperatingPoint(**kw), **vals))
    return out_t, out_j


def _idx(chosen, results):
    return [next(i for i, r in enumerate(results) if r is c) for c in chosen]


@pytest.mark.parametrize("seed", range(8))
def test_frontier_and_selection_match_jax(seed):
    rt, rj = _sweeps(seed)
    assert _idx(pareto.pareto_frontier(rt), rt) == _idx(jpareto.pareto_frontier(rj), rj)
    for target in (0.55, 0.75, 0.9, 0.99):
        assert _idx([pareto.select_operating_point(rt, target)], rt) == _idx(
            [jpareto.select_operating_point(rj, target)], rj)
        for load in (0.0, 0.1, 0.33, 0.5, 0.77, 1.0, 1.5, -0.2):
            assert _idx([pareto.select_operating_point(rt, target, load)], rt) == _idx(
                [jpareto.select_operating_point(rj, target, load)], rj)
    front_t = pareto.pareto_frontier(rt)
    front_j = jpareto.pareto_frontier(rj)
    assert [(_idx([a], rt), _idx([b], rt)) for a, b in
            pareto.dominated_frontier_points(front_t, rt)] == [
        (_idx([a], rj), _idx([b], rj)) for a, b in jpareto.dominated_frontier_points(front_j, rj)]
    assert pareto.adaptive_beats_fixed(rt) == jpareto.adaptive_beats_fixed(rj)


@pytest.mark.parametrize("seed", range(8))
def test_degradation_ladder_matches_jax(seed):
    rt, rj = _sweeps(seed)
    for max_rungs in (1, 2, 3, 5):
        for nominal in (None, 0, 5):
            nt = None if nominal is None else rt[nominal]
            nj = None if nominal is None else rj[nominal]
            got = pareto.degradation_ladder(rt, nominal=nt, max_rungs=max_rungs)
            want = jpareto.degradation_ladder(rj, nominal=nj, max_rungs=max_rungs)
            # The JAX rungs also carry its ``block_c`` knob (None), which the
            # port has no counterpart for.
            assert got == [{k: v for k, v in w.items() if k != "block_c"} for w in want]
            assert all(w["block_c"] is None for w in want)


def test_report_matches_jax():
    rt, rj = _sweeps(3)
    got = pareto.make_report(rt, k=10, n_queries=64, recall_target=0.8, device="cpu")
    want = jpareto.make_report(rj, k=10, n_queries=64, recall_target=0.8)
    assert got["checks"] == want["checks"]
    assert got["aqt_metric"] == want["aqt_metric"] == "modeled_from_measured_walls"
    assert [p["on_frontier"] for p in got["points"]] == [p["on_frontier"] for p in want["points"]]
    strip = lambda d: {k: v for k, v in d.items() if k != "block_c"}
    assert got["selected"] == strip(want["selected"])
    assert pareto.make_report(rt, k=10, n_queries=64, device="cuda")["aqt_metric"] == "measured_wall"


def test_point_labels_and_grid_match_jax():
    kw = dict(n_probes=(2, 5), margins=(0.05, 0.1), rescore_factors=(2, 4), block_qs=(None, 8),
              sketch_factors=(None, 4))
    got = pareto.default_grid(**kw)
    want = jpareto.default_grid(**kw)
    assert [p.label() for p in got] == [p.label() for p in want]
    assert [p.search_kwargs() for p in got] == [
        {k: v for k, v in p.search_kwargs().items() if k != "block_c"} for p in want]


@pytest.fixture(scope="module")
def small():
    x = synthetic.retrieval_corpus(0, 3000, 32, device="cpu")
    q, rel = synthetic.retrieval_queries(1, x, 48)
    gt = flat_search(x, q, k=10)
    cfg = lider.LiderConfig(n_clusters=16, n_arrays=4, n_leaves=4, kmeans_iters=6,
                            storage_dtype="int8")
    return lider.build_lider(0, x, cfg, device="cpu"), q, rel, gt


def test_sweep_bookkeeping_on_the_cpu(small):
    params, q, rel, gt = small
    grid = pareto.default_grid(n_probes=(2, 8), margins=(0.05,), rescore_factors=(4,),
                               block_qs=(None, 8))
    res = pareto.sweep(params, q, gt.ids, grid, k=10, relevant=rel, repeats=1)
    assert len(res) == len(grid)
    for r in res:
        p = r.point
        out = lider.search_lider(params, q, k=10, **p.search_kwargs())
        assert r.recall == float(recall_at_k(out.ids, gt.ids))
        if not p.adaptive:
            assert r.wall_aqt_s == r.wall_full_s and r.pruned_fraction == 0.0
        live = 1.0 - r.pruned_fraction
        assert r.aqt_s == pytest.approx(r.wall_route_s + max(r.wall_full_s - r.wall_route_s, 0.0) * live)
        assert r.storage_dtype == "int8" and r.rescore_tier == "device" and r.host_fetch_s == 0.0
        assert 0.0 <= r.mrr10 <= 1.0
    host = pareto.sweep(lider.set_rescore_tier(params, "host"), q, gt.ids, grid[:2], k=10,
                        repeats=1)
    assert all(r.rescore_tier == "host" and r.host_fetch_s > 0 for r in host)
    assert [r.recall for r in host] == [r.recall for r in res[:2]]


def test_tune_and_cli(small, tmp_path):
    params, q, _, gt = small
    report = pareto.tune(params, q, gt.ids, k=10, recall_target=0.5, repeats=1,
                         grid=pareto.default_grid(n_probes=(2, 4), margins=(0.1,)))
    assert report["backend"] == "cpu" and len(report["points"]) == 4  # 2 fixed, 2 adaptive
    assert report["selected"]["meets_target"] in (True, False)
    out = tmp_path / "tradeoff.json"
    pareto.main(["--smoke", "--device", "cpu", "--corpus-size", "2000", "--queries", "32",
                 "--n-probes", "2", "4", "--margins", "0.1", "--storage-dtypes", "int8",
                 "--rescore-factors", "4", "--no-check", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rep["storage_dtypes"] == ["int8"] and rep["build"]["corpus_size"] == 2000
    assert len(rep["points"]) == 4 and rep["frontier"]
