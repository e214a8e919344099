"""The port's serving engine (``repro_torch.serving``): batching, padding,
result routing, AQT accounting, the pipelined host-tier drain, the online
block_q ladder, transactional updates with the device/host generation
split, and fetch retry / degrade. The cases of the JAX package's
``tests/test_serving.py``, the engine cases of ``tests/test_tiered.py`` and
``tests/test_faults.py``, run on the port.

Against the JAX package: both engines, with ``SchedulerConfig()`` defaults
(fixed batches, no clock-dependent sizing), answer the same request stream
over the same JAX-built index with equal ids (scores to rtol 1e-5 / atol
1e-6, ``repro_torch.testing``), on both tiers.

The ``gpu`` cases run the pipelined drain on the card: its answers equal
the serial search's bit for bit, and no staging buffer is written while its
copy to the card is still pending. JAX is imported only inside the tests
that use it, so this file also collects where JAX is not installed.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import faults
from repro_torch.core import lider, update
from repro_torch.core.baselines import flat_search
from repro_torch.core.core_model import TopK
from repro_torch.core.utils import recall_at_k
from repro_torch.data import synthetic
from repro_torch.serving import (
    EVICTED,
    DegradePolicy,
    QueryResult,
    RetrievalEngine,
    Shed,
    make_backend,
    make_trace,
    pick_block_q,
    run_open_loop,
)
from repro_torch.testing import SCORE_ATOL, SCORE_RTOL

N, D = 4000, 64
CFG = lider.LiderConfig(n_clusters=32, n_probe=8, n_arrays=4, n_leaves=4, kmeans_iters=8)


@pytest.fixture(scope="module")
def data():
    """Corpus, 64 queries and their exact top-10."""
    x = synthetic.retrieval_corpus(0, N, D, device="cpu")
    q, _ = synthetic.retrieval_queries(1, x, 64)
    return x, q, flat_search(x, q, k=10).ids


@pytest.fixture(scope="module")
def host_index(data):
    """An int8 index on the host tier."""
    x, _, _ = data
    cfg = dataclasses.replace(CFG, storage_dtype="int8", rescore_tier="host")
    return lider.build_lider(0, x, cfg, device="cpu")


def _search(p, q, **kw):
    return lider.search_lider(p, q, k=10, n_probe=8, r0=8, **kw)


def _host_engine(ph, **kw):
    search = make_backend("lider", None, updatable=True, n_probe=8, r0=8, **kw)
    return RetrievalEngine(search, batch_size=16, k=10, dim=D, params=ph)


def serve(engine, q):
    rids = [engine.submit(v) for v in np.asarray(q)]
    engine.drain()
    return [engine.result(r) for r in rids]


def ids_of(results):
    return np.stack([np.asarray(r.ids) for r in results])


# ---------------------------------------------------------------------------
# Batching, padding, routing, bounds (tests/test_serving.py)
# ---------------------------------------------------------------------------


def test_engine_routes_results_correctly(data):
    x, q, _ = data
    engine = RetrievalEngine(make_backend("flat", None, x, device="cpu"), batch_size=16, k=5, dim=D)
    engine.warmup()
    rids = [engine.submit(v) for v in q[:40].numpy()]  # not a multiple of the batch
    engine.drain()
    gt = flat_search(x, q[:40], k=5)
    for i, rid in enumerate(rids):
        ids, _ = engine.result(rid)
        np.testing.assert_array_equal(ids, gt.ids[i].numpy())
    s = engine.stats
    assert s.n_queries == 40 and s.n_batches == 3 and s.aqt > 0
    assert s.n_padded == 8 and s.padding_fraction == pytest.approx(8 / 48)


def test_engine_full_batches_have_zero_padding(data):
    x, q, _ = data
    engine = RetrievalEngine(make_backend("flat", None, x, device="cpu"), batch_size=16, k=5, dim=D)
    serve(engine, q[:32])
    assert engine.stats.n_padded == 0 and engine.stats.padding_fraction == 0.0


def test_engine_lider_backend(data):
    x, q, gt = data
    index = lider.build_lider(0, x, CFG, device="cpu")
    engine = RetrievalEngine(make_backend("lider", index, n_probe=8, r0=8), batch_size=32, k=10, dim=D)
    out = serve(engine, q[:32])
    assert float(recall_at_k(torch.from_numpy(ids_of(out)), gt[:32])) > 0.8
    np.testing.assert_array_equal(ids_of(out), _search(index, q[:32]).ids.numpy())
    assert engine.stats.n_probes_total == 0  # no pruning configured
    assert len(engine.stats.batch_pruned_fraction) == 0


def test_engine_lider_backend_reports_pruned_probes(data):
    x, q, _ = data
    index = lider.build_lider(0, x, CFG, device="cpu")
    search = make_backend("lider", index, n_probe=8, r0=8, prune_margin=0.1)
    engine = RetrievalEngine(search, batch_size=16, k=10, dim=D)
    out = serve(engine, q[:40])  # a padded last batch
    s = engine.stats
    assert s.n_probes_total == 40 * 8  # only real queries count
    assert 0 < s.n_probes_pruned < s.n_probes_total
    assert len(s.batch_pruned_fraction) == s.n_batches == 3
    assert s.pruned_probe_fraction == pytest.approx(s.n_probes_pruned / s.n_probes_total)
    assert all(r is not None for r in out)


def test_results_map_does_not_grow_across_drains(data):
    x, q, _ = data
    engine = RetrievalEngine(make_backend("flat", None, x, device="cpu"), batch_size=16, k=5, dim=D)
    engine.warmup()
    sizes = []
    for _ in range(4):
        rids = [engine.submit(v) for v in q[:16].numpy()]
        engine.drain()
        assert all(engine.result(r) is not None for r in rids)
        sizes.append(len(engine.results))
    assert sizes == [0, 0, 0, 0]
    assert engine.result(rids[0]) is None  # popped once -> gone


def test_result_keep_leaves_entry_in_map(data):
    x, q, _ = data
    engine = RetrievalEngine(make_backend("flat", None, x, device="cpu"), batch_size=8, k=5, dim=D)
    rid = engine.submit(q[0].numpy())
    engine.drain()
    assert engine.result(rid, keep=True) is not None
    assert len(engine.results) == 1
    assert engine.result(rid) is not None
    assert len(engine.results) == 0


def test_results_map_bounded_when_never_collected(data):
    x, q, _ = data
    engine = RetrievalEngine(make_backend("flat", None, x, device="cpu"), batch_size=16, k=5, dim=D, max_results=32)
    rids = []
    for _ in range(4):  # 64 answered, bound 32
        rids += [engine.submit(v) for v in q[:16].numpy()]
        engine.drain()
    assert len(engine.results) == 32 and engine.stats.n_results_evicted == 32
    for rid in rids[:32]:  # oldest evicted -> falsy sentinel, not None
        assert engine.result(rid) is EVICTED and not engine.result(rid)
    for rid in rids[32:]:
        assert engine.result(rid) is not None


def test_max_results_must_fit_a_batch(data):
    x, _, _ = data
    with pytest.raises(ValueError):
        RetrievalEngine(make_backend("flat", None, x, device="cpu"), batch_size=16, k=5, dim=D, max_results=8)


class _SlowHostArray:
    """A finished result whose copy to the host is slow."""

    def __init__(self, arr, delay_s):
        self._arr = arr
        self._delay_s = delay_s

    def __array__(self, dtype=None, copy=None):
        time.sleep(self._delay_s)
        return self._arr


def test_aqt_window_excludes_host_copies():
    b, k, dim, delay = 4, 3, 8, 0.15

    def search(q, kk):
        ids = np.tile(np.arange(k, dtype=np.int32), (b, 1))
        scores = np.zeros((b, k), np.float32)
        return TopK(ids=_SlowHostArray(ids, delay), scores=_SlowHostArray(scores, delay))

    search.device = "cpu"
    engine = RetrievalEngine(search, batch_size=b, k=k, dim=dim)
    rids = [engine.submit(np.zeros(dim, np.float32)) for _ in range(b)]
    t0 = time.perf_counter()
    engine.drain()
    assert time.perf_counter() - t0 >= 2 * delay  # both copies happened...
    assert engine.stats.total_time_s < delay  # ...outside the AQT window
    ids, _ = engine.result(rids[0])
    np.testing.assert_array_equal(ids, np.arange(k, dtype=np.int32))


def _bare_search(q, kk):
    return flat_search(torch.zeros((8, D)), torch.as_tensor(q), k=kk)


@pytest.mark.parametrize("what", ["flat backend from numpy", "engine over a backend naming no device"])
def test_no_device_means_the_card(data, what):
    """As every entry point of the port: no device means the card, which
    raises when there is none; the CPU is used only when asked for."""
    x, _, _ = data
    if what == "flat backend from numpy":
        make = lambda **kw: make_backend("flat", None, x.numpy(), **kw)
        assert make(device="cpu").device == torch.device("cpu")
    else:
        make = lambda: RetrievalEngine(_bare_search, batch_size=4, k=3, dim=D)
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("kind", ["pq", "ivfpq", "sklsh", "mplsh"])
def test_unported_backends_raise(data, kind):
    """The backends that once raised ``NotImplementedError`` are ported:
    each serves its baseline's index where the index lives and answers a
    batch as the baseline's search does; each still refuses a knob it
    does not take."""
    from repro_torch.core import baselines

    x, q, _ = data
    build = {"pq": baselines.build_pq, "ivfpq": baselines.build_ivfpq,
             "sklsh": baselines.build_sklsh, "mplsh": baselines.build_mplsh}[kind]
    index = build(torch.Generator().manual_seed(0), x)
    search = make_backend(kind, index, x)
    assert search.device == torch.device("cpu")
    want = {"pq": lambda: baselines.pq_search(index, q[:8], k=10),
            "ivfpq": lambda: baselines.ivfpq_search(index, q[:8], k=10, n_probe=8),
            "sklsh": lambda: baselines.sklsh_search(index, x, q[:8], k=10),
            "mplsh": lambda: baselines.mplsh_search(index, x, q[:8], k=10, n_probes=8)}[kind]()
    got = search(q[:8], 10)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    with pytest.raises(TypeError, match="unexpected kwargs"):
        make_backend(kind, index, x, r0=4)


def test_backend_kwargs_are_checked(data):
    x, _, _ = data
    with pytest.raises(TypeError, match="use_fused"):
        make_backend("lider", None, updatable=True, use_fused=False)
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("hnsw", None, x)
    with pytest.raises(ValueError, match="updatable"):
        make_backend("flat", None, x, updatable=True)


# ---------------------------------------------------------------------------
# The pipelined host-tier drain (tests/test_tiered.py)
# ---------------------------------------------------------------------------


def test_engine_serves_host_tier_with_overlap(data, host_index):
    """Every batch but the last fetches under a dispatched next batch; the
    answers equal the serial staged search, and recall holds."""
    _, q, gt = data
    eng = _host_engine(host_index)
    eng.warmup()
    got = ids_of(serve(eng, q[:48]))
    s = eng.stats
    assert s.n_batches == 3 and s.n_host_fetches == 3
    assert s.n_overlapped_fetches == 2 and s.overlap_fraction == pytest.approx(2 / 3)
    assert s.host_fetch_us > 0 and s.aqt > 0
    assert s.host_fetch_bytes == 3 * 16 * 40 * D * 4  # B * k' * d floats a batch
    assert len(s.batch_latency_s) == 3
    np.testing.assert_array_equal(got, _search(host_index, q[:48]).ids.numpy())
    assert float(recall_at_k(torch.from_numpy(got), gt[:48])) > 0.85
    assert s.n_probes_total == 0  # no pruning configured


def test_open_loop_drain_chunk_one_keeps_overlap(data, host_index):
    """Open-loop replay with ``drain_chunk=1`` still dispatches two batches
    a drain on the host tier, so fetches overlap."""
    _, q, _ = data
    eng = _host_engine(host_index)
    eng.warmup()
    pool = q[:32].numpy()
    trace = make_trace(seed=0, n_arrivals=64, pool_size=len(pool), mean_rate=1e5)
    rids = run_open_loop(eng, trace, pool, drain_chunk=1)
    assert len(rids) == 64
    out = [eng.result(r) for r in rids]
    want = _search(host_index, torch.from_numpy(pool)).ids.numpy()
    np.testing.assert_array_equal(ids_of(out), want[[a.query_idx for a in trace]])
    assert eng.stats.n_host_fetches >= 2 and eng.stats.overlap_fraction > 0


def test_pick_block_q_cost_model():
    assert pick_block_q([np.ones(64, np.int64)], (2, 4, 8)) == 2
    assert pick_block_q([np.full(4, 128, np.int64)], (2, 4, 8)) == 8
    assert pick_block_q([], (4, 8)) == 4


def test_pick_block_q_matches_jax():
    from repro.serving.engine import pick_block_q as jpick

    rng = np.random.default_rng(0)
    for _ in range(20):
        window = [rng.integers(1, 40, rng.integers(1, 30)) for _ in range(rng.integers(0, 5))]
        assert pick_block_q(window, (2, 4, 8, 16)) == jpick(window, (2, 4, 8, 16))


def test_engine_autotunes_block_q_without_recompile(data, host_index):
    """Hot traffic climbs to the deepest rung; the schedule's sharing lands
    in the stats; the answers equal the serial search; nothing re-warms."""
    x, q, _ = data
    ladder = (2, 4, 8)
    eng = RetrievalEngine(
        make_backend("lider", None, updatable=True, n_probe=8, r0=8),
        batch_size=16, k=10, dim=D, params=host_index, block_q_ladder=ladder,
    )
    eng.warmup()
    before = lider.query_path_cache_size()
    assert before > 0
    rng = np.random.default_rng(0)
    hot = q[:1].numpy() + 1e-3 * rng.normal(size=(48, D))
    hot = (hot / np.linalg.norm(hot, axis=-1, keepdims=True)).astype(np.float32)
    got = ids_of(serve(eng, hot))
    assert lider.query_path_cache_size() == before  # no new signature while adapting
    np.testing.assert_array_equal(got, _search(host_index, torch.from_numpy(hot)).ids.numpy())
    s = eng.stats
    assert eng.recompiles == 0
    assert s.n_sched_pairs == 48 * 8 and 0 < s.n_sched_steps < s.n_sched_pairs
    assert s.sharing_ratio > 2.0 and s.n_batches == 3
    assert eng._auto_block_q == 8
    assert pick_block_q(eng._probe_counts, ladder) == 8


def test_engine_static_block_q_overrides_autotune(data, host_index):
    _, q, _ = data
    search = make_backend("lider", None, updatable=True, n_probe=8, r0=8, block_q=4)
    eng = RetrievalEngine(search, batch_size=16, k=10, dim=D, params=host_index, block_q_ladder=(2, 8))
    eng.warmup()
    assert (eng._effective_point() or {}).get("block_q") is None
    assert search.static_point.get("block_q") == 4
    got = ids_of(serve(eng, q[:16]))
    np.testing.assert_array_equal(got, _search(host_index, q[:16], block_q=4).ids.numpy())


def test_engine_host_tier_reports_pruned_probes(data, host_index):
    _, q, _ = data
    eng = _host_engine(host_index, prune_margin=0.1)
    out = serve(eng, q[:40])
    s = eng.stats
    assert s.n_probes_total == 40 * 8
    assert 0 < s.n_probes_pruned < s.n_probes_total
    assert all(r is not None for r in out)


def test_host_only_update_does_not_recompile(data):
    x, _, _ = data
    ph = lider.build_lider(
        0, x, dataclasses.replace(CFG, storage_dtype="int8", rescore_tier="host"),
        device="cpu",
    )
    eng = _host_engine(ph)
    eng.warmup()
    before = lider.query_path_cache_size()
    assert before > 0

    def host_only(params):
        st = params.bank.store
        st.write_rows(torch.tensor([0]), st.fetch(torch.tensor([0])))
        return params

    assert not eng.apply_updates(host_only)
    assert eng.recompiles == 0 and eng.device_generation == 0
    assert eng.host_generation == 1 and eng.generation == 1
    serve(eng, x[:16])
    assert lider.query_path_cache_size() == before


def test_generations_split_on_mixed_update(data):
    x, q, _ = data
    cfg = dataclasses.replace(CFG, storage_dtype="int8", rescore_tier="host", capacity=512)
    ph = lider.build_lider(0, x, cfg, device="cpu")
    pd = lider.set_rescore_tier(lider.build_lider(0, x, cfg, device="cpu"), "device")
    eng = _host_engine(ph)
    eng.warmup()
    new = x[:8] + 0.01
    assert not eng.apply_updates(lambda p: update.upsert(p, new))
    assert eng.recompiles == 0
    assert eng.device_generation == 1  # codes, scales and gids changed
    assert eng.host_generation == 1  # rescore rows written in lockstep
    # The served answers equal a device-tier copy that took the same upsert.
    pd, _ = update.upsert(pd, new)
    got = serve(eng, q[:32])
    want = _search(pd, q[:32])
    np.testing.assert_array_equal(ids_of(got), want.ids.numpy())
    np.testing.assert_array_equal(np.stack([r.scores for r in got]), want.scores.numpy())


# ---------------------------------------------------------------------------
# Faults (tests/test_faults.py)
# ---------------------------------------------------------------------------


def _fault_engine(ph, times, **policy):
    plan = faults.FaultPlan([faults.FaultSpec("host_fetch", mode="error", times=times)])
    eng = RetrievalEngine(
        make_backend("lider", None, updatable=True, n_probe=8, r0=8),
        batch_size=16, k=10, dim=D, params=ph, fault_plan=plan,
        policy=DegradePolicy(fetch_retries=2, fetch_backoff_s=0.0, **policy),
    )
    eng.warmup()
    return eng


def test_fetch_fault_retried_transparently(data, host_index):
    _, q, _ = data
    eng = _fault_engine(host_index, (0,))
    out = serve(eng, q[:16])
    assert eng.stats.n_fetch_retries == 1 and eng.stats.n_fetch_failures == 0
    assert not any(r.degraded for r in out)
    want = _search(host_index, q[:16])
    np.testing.assert_array_equal(ids_of(out), want.ids.numpy())
    np.testing.assert_array_equal(np.stack([r.scores for r in out]), want.scores.numpy())


def test_fetch_exhaustion_degrades_instead_of_raising(data, host_index):
    _, q, _ = data
    eng = _fault_engine(host_index, (0, 1, 2))
    out = serve(eng, q[:16])  # must not raise
    assert eng.stats.n_fetch_failures == 1
    assert all(r.degraded for r in out) and eng.stats.n_degraded == 16
    prov, _ = lider.host_first_pass(host_index, q[:16], k=10, n_probe=8, r0=8)
    deg = lider.compressed_only_topk(host_index.bank.gids, prov, k=10)
    np.testing.assert_array_equal(ids_of(out), deg.ids.numpy())
    np.testing.assert_array_equal(np.stack([r.scores for r in out]), deg.scores.numpy())
    out2 = serve(eng, q[:16])  # outage over: full quality again
    assert not any(r.degraded for r in out2)
    np.testing.assert_array_equal(ids_of(out2), _search(host_index, q[:16]).ids.numpy())


def test_apply_updates_rolls_back_on_injected_fault(data):
    x, q, _ = data
    cfg = dataclasses.replace(CFG, storage_dtype="int8", rescore_tier="host", capacity=512)
    ph = lider.build_lider(0, x[:3000], cfg, device="cpu")
    plan = faults.FaultPlan([faults.FaultSpec("host_write", mode="error", times=(0,))])
    eng = RetrievalEngine(
        make_backend("lider", None, updatable=True, n_probe=8, r0=8),
        batch_size=16, k=10, dim=D, params=ph, fault_plan=plan,
    )
    eng.warmup()
    table = ph.bank.store.rescore.clone()
    before = serve(eng, q[:16])
    with pytest.raises(faults.InjectedFault):
        eng.apply_updates(lambda p: update.upsert(p, x[3000:]))
    assert eng.stats.n_update_rollbacks == 1 and eng.generation == 0
    assert not eng.params.bank.store.in_txn
    assert torch.equal(eng.params.bank.store.rescore, table)
    after = serve(eng, q[:16])
    np.testing.assert_array_equal(ids_of(before), ids_of(after))
    eng.apply_updates(lambda p: update.upsert(p, x[3000:]))  # the retry commits
    assert eng.generation == 1
    assert (ids_of(serve(eng, x[3000:3016])) >= 3000).any()  # upserted gids start at 3000


def test_deadline_pressure_steps_down_ladder(data, host_index):
    _, q, _ = data
    ladder = ({"n_probe": 2, "expected_recall": 0.5},)
    eng = RetrievalEngine(
        make_backend("lider", None, updatable=True, n_probe=8, r0=8),
        batch_size=16, k=10, dim=D, params=host_index,
        policy=DegradePolicy(ladder=ladder, deadline_s=1e-6, degrade_age_fraction=0.5),
    )
    eng.warmup()
    out = serve(eng, q[:16])
    assert eng.stats.n_rung_steps >= 1
    assert all(r.rung == 1 and not r.degraded for r in out)
    assert eng.stats.n_deadline_misses == 16
    want = lider.search_lider(host_index, q[:16], k=10, n_probe=2, r0=8)
    np.testing.assert_array_equal(ids_of(out), want.ids.numpy())


def test_queue_cap_sheds_with_structured_answer(data, host_index):
    _, q, _ = data
    eng = RetrievalEngine(
        make_backend("lider", None, updatable=True, n_probe=8, r0=8),
        batch_size=16, k=10, dim=D, params=host_index, policy=DegradePolicy(max_queue=4),
    )
    rids = [eng.submit(v) for v in q[:6].numpy()]
    eng.drain()
    served = [eng.result(r) for r in rids[:4]]
    shed = [eng.result(r) for r in rids[4:]]
    assert all(isinstance(r, QueryResult) for r in served)
    assert all(isinstance(r, Shed) and r.reason == "queue_full" for r in shed)
    assert eng.stats.n_shed == 2 and eng.stats.n_queries == 4


def test_execute_chunk_returns_answers_in_order(data, host_index):
    _, q, _ = data
    eng = _host_engine(host_index)
    eng.warmup()
    rids = [eng.submit(v) for v in q[:12].numpy()]
    chunk = eng.scheduler.take(12)
    assert [r.rid for r in chunk] == rids
    out = eng.execute_chunk(chunk)
    np.testing.assert_array_equal(ids_of(out), _search(host_index, q[:12]).ids.numpy())
    assert len(eng.results) == 0


# ---------------------------------------------------------------------------
# Against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["device", "host"])
def test_engine_matches_jax_engine(tmp_path, tier):
    """The same request stream through both packages' engines over one
    JAX-built int8 index (the port loads JAX's save), default scheduler."""
    import jax
    import jax.numpy as jnp

    from repro.core import lider as jlider
    from repro.data import synthetic as jsyn
    from repro.serving import RetrievalEngine as JEngine
    from repro.serving import make_backend as jmake_backend
    from repro.training import checkpoint as jckpt
    from repro_torch.training import checkpoint

    x = np.array(jsyn.retrieval_corpus(0, 2000, 32))
    q = np.array(jsyn.retrieval_queries(1, jnp.asarray(x), 40)[0])
    jp = jlider.build_lider(
        jax.random.PRNGKey(0), jnp.asarray(x),
        jlider.LiderConfig(n_clusters=16, n_probe=4, kmeans_iters=10, storage_dtype="int8"),
    )
    jp = jlider.set_rescore_tier(jp, tier)
    jckpt.save_index(str(tmp_path), jp)
    tp = checkpoint.load_index(str(tmp_path), device="cpu")
    assert tp.bank.rescore_tier == tier
    jeng = JEngine(jmake_backend("lider", None, updatable=True, n_probe=4), batch_size=16, k=10,
                   dim=32, params=jp)
    teng = RetrievalEngine(make_backend("lider", None, updatable=True, n_probe=4), batch_size=16,
                           k=10, dim=32, params=tp)
    for eng in (jeng, teng):
        eng.warmup()
    jout, tout = serve(jeng, q), serve(teng, q)
    np.testing.assert_array_equal(ids_of(tout), ids_of(jout))
    np.testing.assert_allclose(
        np.stack([r.scores for r in tout]), np.stack([np.asarray(r.scores) for r in jout]),
        rtol=SCORE_RTOL, atol=SCORE_ATOL,
    )
    assert teng.stats.n_batches == jeng.stats.n_batches == 3
    assert teng.stats.n_padded == jeng.stats.n_padded == 8
    if tier == "host":
        assert teng.stats.n_overlapped_fetches == jeng.stats.n_overlapped_fetches == 2


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cuda_host_index(data):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, _, _ = data
    cfg = dataclasses.replace(CFG, storage_dtype="int8", rescore_tier="host")
    return lider.build_lider(0, x.cuda(), cfg, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("block_q", [None, 8])
def test_pipelined_drain_equals_unpipelined(data, block_q):
    """Many batches through the pipelined drain on the card: ids and scores
    equal the serial search of each batch, bit for bit."""
    ph = _cuda_host_index(data)
    _, q, _ = data
    kw = {} if block_q is None else {"block_q": block_q}
    eng = RetrievalEngine(make_backend("lider", None, updatable=True, n_probe=8, r0=8, **kw),
                          batch_size=8, k=10, dim=D, params=ph)
    eng.warmup()
    out = serve(eng, q)
    assert eng.stats.n_batches == 8 and eng.stats.overlap_fraction > 0
    want = [_search(ph, q[i : i + 8].cuda(), **kw) for i in range(0, 64, 8)]
    np.testing.assert_array_equal(ids_of(out), torch.cat([w.ids for w in want]).cpu().numpy())
    np.testing.assert_array_equal(
        np.stack([r.scores for r in out]), torch.cat([w.scores for w in want]).cpu().numpy()
    )


@pytest.mark.gpu
def test_staging_buffer_not_rewritten_before_its_copy(data, monkeypatch):
    """Many small batches through the two slots: at every gather into a slot's
    staging buffer, that slot's last copy to the card has completed."""
    ph = _cuda_host_index(data)
    _, q, _ = data
    eng = RetrievalEngine(make_backend("lider", None, updatable=True, n_probe=8, r0=8),
                          batch_size=4, k=10, dim=D, params=ph)
    eng.warmup()
    store = ph.bank.store
    real_fetch = store.fetch
    checked = []

    def fetch(rows, *, out=None):
        for slot in eng._slots:
            staging = slot.buffers.get("staging")
            if out is not None and staging is not None and out.data_ptr() == staging.data_ptr():
                checked.append(slot.copied.query())
        return real_fetch(rows, out=out)

    monkeypatch.setattr(store, "fetch", fetch)
    qs = q.repeat(2, 1)
    out = serve(eng, qs)
    assert len(checked) == 32 and all(checked)
    want = _search(ph, qs.cuda())
    np.testing.assert_array_equal(ids_of(out), want.ids.cpu().numpy())


@pytest.mark.gpu
def test_fetch_starts_under_the_next_first_pass(data):
    """Each batch's host gather begins while the device still runs the next
    batch's first pass: the drain waits on the rows' own event, never on
    the stream. A sleep queued after every first pass keeps that pass on
    the device long enough to be seen."""
    ph = _cuda_host_index(data)
    _, q, _ = data
    search = make_backend("lider", None, updatable=True, n_probe=8, r0=8)
    first_pass = search.host_stage1

    def slow_first_pass(*args, **kw):
        out = first_pass(*args, **kw)
        torch.cuda._sleep(20_000_000)  # ~10 ms of device time
        return out

    search.host_stage1 = slow_first_pass
    eng = RetrievalEngine(search, batch_size=8, k=10, dim=D, params=ph)
    eng.warmup()
    out = serve(eng, q)
    s = eng.stats
    assert s.n_host_fetches == 8 and s.n_overlapped_fetches == 7
    assert s.n_fetches_under_device_work == 7
    np.testing.assert_array_equal(ids_of(out), _search(ph, q.cuda()).ids.cpu().numpy())
