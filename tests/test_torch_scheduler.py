"""The port's serving front end (``repro_torch.serving.scheduler`` and
``traffic``): weighted-fair queues, admission, batch sizing, the load
signal, the result cache and its coherence, dynamic batches, the fetch
backoff path and bounded stats; the cases of the JAX package's
``tests/test_scheduler.py`` run on the port.

The scheduler and the traffic generator are the port's own copies of the
JAX package's NumPy modules: the same admission decisions, dequeue order,
batch sizes and load signals on the same request sequence, and the same
seeded traces, exactly. JAX is imported only inside the tests that compare
against it.
"""
import collections
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import faults
from repro_torch.core import lider, update
from repro_torch.core.utils import l2_normalize
from repro_torch.serving import (
    DegradePolicy,
    QueryResult,
    RetrievalEngine,
    SchedulerConfig,
    make_backend,
    make_trace,
    zipf_weights,
)
from repro_torch.serving.engine import EngineStats
from repro_torch.serving.scheduler import Request, ResultCache, Scheduler, batch_ladder

N, DIM, K, BATCH = 600, 16, 5, 16


def _unit(rng, shape):
    return l2_normalize(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(0)
    x = _unit(rng, (N, DIM))
    q = l2_normalize(x[:64] + 0.02).numpy()
    params = lider.build_lider(
        1, x, lider.LiderConfig(n_clusters=8, n_probe=4, n_arrays=4, n_leaves=4, kmeans_iters=5),
        device="cpu",
    )
    return params, q


def build_engine(params, *, sched=None, policy=None, fault_plan=None):
    engine = RetrievalEngine(
        make_backend("lider", None, updatable=True, n_probe=4),
        batch_size=BATCH, k=K, dim=DIM, params=params,
        policy=policy, fault_plan=fault_plan, scheduler=sched,
    )
    engine.warmup()
    return engine


def req(rid, tenant="t", t_submit=0.0):
    return Request(rid=rid, query=np.zeros(2, np.float32), t_submit=t_submit, tenant=tenant)


# ---------------------------------------------------------------------------
# Scheduler unit: ladder, fairness, admission, sizing
# ---------------------------------------------------------------------------


def test_batch_ladder_pow2_and_includes_max():
    assert batch_ladder(32, 1) == (1, 2, 4, 8, 16, 32)
    assert batch_ladder(24, 4) == (4, 8, 16, 24)
    assert batch_ladder(16, 16) == (16,)
    assert batch_ladder(8, 0) == (1, 2, 4, 8)
    with pytest.raises(ValueError):
        batch_ladder(0)


def test_weighted_fair_take_interleaves_skewed_tenants():
    s = Scheduler(SchedulerConfig(), batch_size=8)
    for i in range(12):
        s.admit(req(i, tenant="heavy"))
    for i in range(12, 16):
        s.admit(req(i, tenant="light"))
    tenants = [r.tenant for r in s.take(8)]
    assert tenants.count("heavy") == 4 and tenants.count("light") == 4
    rest = [r.tenant for r in s.take(12)]
    assert rest.count("light") == 0 and rest.count("heavy") == 8


def test_weighted_fair_honors_weights():
    s = Scheduler(SchedulerConfig(tenant_weights={"a": 3.0, "b": 1.0}), batch_size=8)
    for i in range(16):
        s.admit(req(2 * i, tenant="a"))
        s.admit(req(2 * i + 1, tenant="b"))
    got = [r.tenant for r in s.take(8)]
    assert got.count("a") == 6 and got.count("b") == 2


def test_idle_tenant_banks_no_credit():
    s = Scheduler(SchedulerConfig(), batch_size=8)
    for i in range(8):
        s.admit(req(i, tenant="busy"))
    s.take(8)
    for i in range(8, 16):
        s.admit(req(i, tenant="idler"))
    for i in range(16, 24):
        s.admit(req(i, tenant="busy"))
    got = [r.tenant for r in s.take(8)]
    assert got.count("idler") == 4 and got.count("busy") == 4


def test_queue_cap_and_deadline_admission():
    s = Scheduler(SchedulerConfig(slo_s=0.01, deadline_admission=True), batch_size=8)
    assert s.admit(req(0)) is None
    s.observe_service(8, 0.08)  # 10 ms a query
    assert s.admit(req(1)) is None
    assert s.admit(req(2)) == "deadline"
    s2 = Scheduler(SchedulerConfig(max_queue=2), batch_size=8)
    assert s2.admit(req(0)) is None and s2.admit(req(1)) is None
    assert s2.admit(req(2)) == "queue_full"
    # The engine's own cap and the config's: the tighter one wins.
    s3 = Scheduler(SchedulerConfig(max_queue=5), batch_size=8, max_queue=1)
    assert s3.admit(req(0)) is None and s3.admit(req(1)) == "queue_full"


def test_pick_batch_size_tracks_depth_and_slo_headroom():
    s = Scheduler(SchedulerConfig(dynamic_batch=True, min_batch=2, slo_s=0.1), batch_size=16)
    assert s.ladder == (2, 4, 8, 16)
    now = time.perf_counter()
    for i in range(3):
        s.admit(req(i, t_submit=now))
    assert s.pick_batch_size(now) == 4
    for i in range(3, 20):
        s.admit(req(i, t_submit=now))
    assert s.pick_batch_size(now) == 16
    s.observe_service(16, 0.16)
    assert s.pick_batch_size(now + 0.07) == 2


def test_load_signal_tracks_depth_and_age():
    s = Scheduler(SchedulerConfig(dynamic_batch=True, slo_s=0.1, depth_reference=10), batch_size=4)
    now = time.perf_counter()
    assert s.load_signal(now) == 0.0
    for i in range(5):
        s.admit(req(i, t_submit=now))
    assert s.load_signal(now) == pytest.approx(0.5)
    assert s.load_signal(now + 0.09) == pytest.approx(0.9)
    assert s.load_signal(now + 1.0) == 1.0


def test_result_cache_lru_bound_and_context_keys():
    c = ResultCache(2)
    fp = [ResultCache.fingerprint(np.full(4, i, np.float32)) for i in range(3)]
    ctx = (5, 0, 0)  # (k, generation, rung)
    c.put(fp[0], ctx, np.array([1]), np.array([0.5]))
    c.put(fp[1], ctx, np.array([2]), np.array([0.6]))
    assert c.get(fp[0], ctx) is not None
    c.put(fp[2], ctx, np.array([3]), np.array([0.7]))
    assert len(c) == 2
    assert c.get(fp[1], ctx) is None
    assert c.get(fp[0], ctx) is not None
    for other in ((5, 1, 0), (5, 0, 1), (10, 0, 0)):
        assert c.get(fp[0], other) is None
    with pytest.raises(ValueError):
        ResultCache(0)


# ---------------------------------------------------------------------------
# The port's copies against the JAX package's modules
# ---------------------------------------------------------------------------


_CONFIGS = {
    "fifo": (dict(), 8),
    "weighted": (dict(tenant_weights={"t0": 3.0, "t1": 1.0}), 8),
    "dynamic_slo": (dict(dynamic_batch=True, min_batch=2, slo_s=0.05, deadline_admission=True), 16),
    "capped": (dict(max_queue=20, depth_reference=12), 4),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_scheduler_decisions_match_jax(name):
    """One seeded sequence of admissions, service reports, takes and
    sizing queries through both schedulers: every decision equal."""
    from repro.serving import scheduler as jsched

    kw, bs = _CONFIGS[name]
    ours = Scheduler(SchedulerConfig(**kw), batch_size=bs)
    theirs = jsched.Scheduler(jsched.SchedulerConfig(**kw), batch_size=bs)
    assert ours.ladder == theirs.ladder
    rng = np.random.default_rng(0)
    t = 0.0
    for step in range(300):
        t += float(rng.exponential(0.004))
        op = rng.integers(0, 4)
        if op <= 1:
            tenant = f"t{rng.integers(0, 3)}"
            a = ours.admit(req(step, tenant, t))
            b = theirs.admit(jsched.Request(rid=step, query=np.zeros(2, np.float32), t_submit=t,
                                            tenant=tenant))
            assert a == b
        elif op == 2:
            n = int(rng.integers(1, bs + 1))
            assert [r.rid for r in ours.take(n)] == [r.rid for r in theirs.take(n)]
        else:
            secs = float(rng.uniform(0.001, 0.05))
            ours.observe_service(bs, secs)
            theirs.observe_service(bs, secs)
        assert len(ours) == len(theirs)
        assert ours.pick_batch_size(t) == theirs.pick_batch_size(t)
        assert ours.load_signal(t) == theirs.load_signal(t)
        assert ours.oldest_submit() == theirs.oldest_submit()


@pytest.mark.parametrize("pattern", ["closed", "zipf", "burst"])
def test_traffic_traces_match_jax(pattern):
    from repro.serving import traffic as jtraffic

    kw = dict(seed=3, n_arrivals=500, pool_size=64, mean_rate=1000.0, pattern=pattern, n_tenants=3)
    as_tuples = lambda trace: [dataclasses.astuple(a) for a in trace]  # noqa: E731
    assert as_tuples(make_trace(**kw)) == as_tuples(jtraffic.make_trace(**kw))
    np.testing.assert_array_equal(zipf_weights(64, 1.1), jtraffic.zipf_weights(64, 1.1))
    with pytest.raises(ValueError):
        make_trace(**{**kw, "pattern": "poisson"})


# ---------------------------------------------------------------------------
# Engine: cache coherence, dynamic batches, warmed paths
# ---------------------------------------------------------------------------


def test_cache_hits_bit_identical_and_invalidated_on_update(served):
    params, q = served
    engine = build_engine(params, sched=SchedulerConfig(cache_size=256))
    pool = q[:BATCH]

    def serve(vectors):
        rids = [engine.submit(v) for v in vectors]
        engine.drain()
        return [engine.result(r) for r in rids]

    first = serve(pool)
    assert engine.stats.n_cache_hits == 0
    second = serve(pool)
    assert engine.stats.n_cache_hits == BATCH and engine.stats.n_batches == 1
    assert all(r.cached for r in second)
    ref = lider.search_lider(engine.params, pool, k=K, n_probe=4)
    for i, (a, b) in enumerate(zip(first, second)):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.ids, ref.ids[i].numpy())
    extra = _unit(np.random.default_rng(9), (32, DIM))
    engine.apply_updates(lambda p: update.upsert(p, extra))
    third = serve(pool)
    assert engine.stats.n_cache_hits == BATCH
    assert not any(r.cached for r in third)
    ref2 = lider.search_lider(engine.params, pool, k=K, n_probe=4)
    np.testing.assert_array_equal(np.stack([r.ids for r in third]), ref2.ids.numpy())


def test_dynamic_batches_bit_identical_to_fixed(served):
    params, q = served
    fixed = build_engine(params)
    dyn = build_engine(params, sched=SchedulerConfig(dynamic_batch=True, min_batch=2))

    def serve(engine, chunks):
        out = []
        for c in chunks:
            rids = [engine.submit(v) for v in c]
            engine.drain()
            out.extend(engine.result(r) for r in rids)
        return out

    chunks = [q[:3], q[3:10], q[10:26], q[26:27]]  # depths 3, 7, 16, 1
    a, b = serve(fixed, chunks), serve(dyn, chunks)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.ids, rb.ids)
        np.testing.assert_array_equal(ra.scores, rb.scores)
    assert list(dyn.stats.batch_size_trace) == [4, 8, 16, 2]
    assert dyn.stats.n_padded < fixed.stats.n_padded


def test_no_recompiles_across_load_sweep_after_warmup(served):
    """Every batch size and rung was run in warmup: a sweep of queue depths
    re-warms nothing, adds no query-path signature (the counter of the JAX
    package's ``test_no_recompiles_across_load_sweep_after_warmup``) and
    every request is answered."""
    params, q = served
    engine = build_engine(
        params,
        sched=SchedulerConfig(dynamic_batch=True, min_batch=2),
        policy=DegradePolicy(ladder=({"n_probe": 2},), deadline_s=10.0),
    )
    compiled = lider.query_path_cache_size()
    assert compiled > 0  # the counter sees the warmed signatures
    for depth in (1, 2, 3, 5, 8, 13, 16, 27):
        rids = [engine.submit(v) for v in q[:depth]]
        engine.drain()
        for r in rids:
            assert isinstance(engine.result(r), QueryResult)
    assert lider.query_path_cache_size() == compiled
    assert engine.recompiles == 0
    assert set(engine.stats.batch_size_trace) <= set(engine.scheduler.ladder)


# ---------------------------------------------------------------------------
# Engine: fetch backoff yields to the pipeline
# ---------------------------------------------------------------------------


def test_fetch_backoff_does_not_block_other_batches():
    backoff = 0.25
    n, dim, k, batch = 400, 16, 5, 8
    x = _unit(np.random.default_rng(2), (n, dim))
    params = lider.build_lider(
        1, x,
        lider.LiderConfig(n_clusters=8, n_probe=4, n_arrays=4, n_leaves=4, kmeans_iters=5,
                          storage_dtype="int8", rescore_tier="host"),
        device="cpu",
    )
    q = l2_normalize(x[: 2 * batch] + 0.02).numpy()
    # Batch A's first fetch fails and backs off; batch B finishes meanwhile.
    plan = faults.FaultPlan([faults.FaultSpec("host_fetch", mode="error", times=(0,))])
    engine = RetrievalEngine(
        make_backend("lider", None, updatable=True, n_probe=4),
        batch_size=batch, k=k, dim=dim, params=params,
        policy=DegradePolicy(fetch_retries=2, fetch_backoff_s=backoff, fetch_backoff_mult=1.0),
        fault_plan=plan,
    )
    engine.warmup()
    # The engine's own stamps, per batch (keyed by its first request id):
    # the retry_at a failed fetch parks it with, and when each attempt ends.
    parked, finished = {}, {}
    finish = engine._finish_host_batch

    def logged_finish(e):
        done = finish(e)
        key = e.chunk[0].rid
        if done is None:
            parked[key] = e.retry_at
        else:
            finished[key] = time.perf_counter()
        return done

    engine._finish_host_batch = logged_finish
    rids = [engine.submit(v) for v in q]
    engine.drain()
    out = [engine.result(r) for r in rids]
    assert engine.stats.n_fetch_retries == 1 and engine.stats.n_fetch_failures == 0
    assert not any(r.degraded for r in out)
    ref = lider.search_lider(engine.params, q, k=k, n_probe=4)
    np.testing.assert_array_equal(np.stack([r.ids for r in out]), ref.ids.numpy())
    a, b = rids[0], rids[batch]
    assert list(parked) == [a]  # only batch A's fetch failed
    assert min(r.latency_s for r in out[:batch]) >= backoff
    assert finished[a] >= parked[a]  # A waited out its backoff...
    # ...and B was answered before A's retry was due: A's backoff held up
    # no other batch. (B's own latency is no measure: under a loaded CPU
    # the two first passes alone can take longer than the backoff.)
    assert finished[b] < parked[a]


# ---------------------------------------------------------------------------
# Stats boundedness
# ---------------------------------------------------------------------------


def test_all_engine_stat_traces_are_bounded(served):
    for f in dataclasses.fields(EngineStats):
        has_factory = f.default_factory is not dataclasses.MISSING
        default = f.default_factory() if has_factory else None
        if isinstance(default, collections.deque):
            assert default.maxlen is not None, f"EngineStats.{f.name} is unbounded"
        else:
            assert not isinstance(default, list), f"EngineStats.{f.name} is an unbounded list"
    params, q = served
    engine = build_engine(params, sched=SchedulerConfig(cache_size=8))
    for _ in range(3):
        rids = [engine.submit(v) for v in q[:4]]
        engine.drain()
        for r in rids:
            engine.result(r)
    s = engine.stats
    assert len(s.batch_size_trace) <= s.batch_size_trace.maxlen
    assert len(s.recent_latency_s) <= s.recent_latency_s.maxlen
    assert len(s.batch_latency_s) <= s.batch_latency_s.maxlen
