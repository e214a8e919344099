"""The port's replica fabric (``repro_torch.serving.replica`` and
``.router``): the thirteen cases of the JAX package's ``tests/test_router.py``
on the port, at the same data shape (N 400, d 16, an int8 index on the host
tier), ``clone_params`` isolation, and the port's router against JAX's
router on the same index and queries.

The index is built once by the JAX package (``PRNGKey(1)``) and saved; each
replica loads its own copy with the port's ``checkpoint.load_index``, so both
packages serve the same index. Tolerances: router == one engine in the port,
ids and scores bit for bit; the port's router against JAX's: ids exact,
scores to rtol 1e-5 / atol 1e-6 (``repro_torch.testing``: float32 sums in
another order).

The ``gpu`` cases run two replicas on the card: their answers equal one
engine's bit for bit, and the kernels' launch counts, read around the
router's pool threads, are exactly the single engine's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import faults
from repro_torch.core import lider, update
from repro_torch.serving import (
    DEAD,
    HEALTHY,
    RECOVERING,
    SUSPECT,
    HealthPolicy,
    QueryResult,
    QueryRouter,
    ReplicaSet,
    RetrievalEngine,
    RouterConfig,
    Shed,
    clone_params,
    make_backend,
)
from repro_torch.testing import SCORE_ATOL, SCORE_RTOL
from repro_torch.training import checkpoint

N, DIM, K, BATCH = 400, 16, 5, 8
CFG = dict(
    n_clusters=8, n_probe=4, n_arrays=4, n_leaves=4, kmeans_iters=5,
    storage_dtype="int8", rescore_tier="host",
)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(base rows, held-out rows, queries, directory of the JAX-built
    host-tier index over the base rows)."""
    import jax
    import jax.numpy as jnp
    from repro.core import lider as jlider
    from repro.core.utils import l2_normalize
    from repro.training import checkpoint as jckpt

    x = l2_normalize(jax.random.normal(jax.random.PRNGKey(0), (N + 32, DIM)))
    base, held = np.asarray(x[:N]), np.asarray(x[N:])
    q = np.asarray(l2_normalize(x[:N][:32] + 0.02), np.float32)
    jp = jlider.build_lider(jax.random.PRNGKey(1), jnp.asarray(base), jlider.LiderConfig(**CFG))
    d = str(tmp_path_factory.mktemp("router_index"))
    jckpt.save_index(d, jp)
    return base, held, q, d


@pytest.fixture(scope="module")
def card_data():
    """The same shapes made with numpy alone (no JAX on the card), and the
    port's own build of the index on the card."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N + 32, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    base, held = x[:N], x[N:]
    q = base[:32] + np.float32(0.02)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    params = lider.build_lider(1, base, lider.LiderConfig(**CFG), device="cuda")
    return base, held, q.astype(np.float32), params


def load(data, device="cpu"):
    return checkpoint.load_index(data[3], device=device)


def build_engine(data, fault_plan=None, params=None, device="cpu"):
    # Each replica loads its OWN copy of the index (host-tier stores are
    # written in place on update and must never be shared across replicas).
    eng = RetrievalEngine(
        make_backend("lider", None, updatable=True, n_probe=4),
        batch_size=BATCH, k=K, dim=DIM,
        params=load(data, device) if params is None else params,
        fault_plan=fault_plan,
    )
    eng.warmup()
    return eng


def run(router, queries, *, max_dispatches=None):
    rids = [router.submit(v) for v in queries]
    while router.pending_requests:
        router.drain(max_dispatches=max_dispatches)
    return [router.result(r) for r in rids]


def serve_single(engine, queries):
    out = []
    for v in queries:
        rid = engine.submit(v)
        engine.drain()
        out.append(engine.result(rid))
    return out


def assert_same(res, want):
    for a, b in zip(res, want):
        np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
        np.testing.assert_array_equal(np.asarray(a.scores), np.asarray(b.scores))


def upsert_fn(rows):
    rows = torch.from_numpy(np.array(rows, np.float32))
    return lambda p: update.upsert(p, rows.to(p.device))


# ---------------------------------------------------------------------------
# Health state machine (no engines needed)
# ---------------------------------------------------------------------------
class _FakeEngine:
    generation = 0


def test_health_state_machine_transitions():
    pol = HealthPolicy(dead_after=2, recover_successes=2, reprobe_backoff_s=0.01)
    rs = ReplicaSet([_FakeEngine(), _FakeEngine()], policy=pol)
    r = rs.get("r0")
    assert r.state == HEALTHY

    rs.record_failure(r, now=0.0)
    assert r.state == SUSPECT
    rs.record_success(r, 0.01)
    assert r.state == HEALTHY  # one success clears suspicion

    rs.record_failure(r, now=0.0)
    rs.record_failure(r, now=0.0)
    assert r.state == DEAD and not r.serveable()
    assert 0.01 <= r.reprobe_at < 0.02  # seeded jitter in [1, 2)

    rs.tick(now=r.reprobe_at - 1e-4)
    assert r.state == DEAD  # backoff window not over yet
    rs.tick(now=r.reprobe_at + 1e-4)
    assert r.state == RECOVERING  # reprobe heartbeat succeeded (no plan)
    rs.record_success(r, 0.01)
    assert r.state == HEALTHY  # recover_successes reached
    assert r.backoff_s is None  # backoff reset on full recovery


def test_failed_reprobe_doubles_backoff_deterministically():
    plan = faults.FaultPlan(
        [faults.FaultSpec("replica_heartbeat", mode="error", times=(0,))], seed=0
    )

    def windows(seed):
        rs = ReplicaSet(
            [_FakeEngine()],
            policy=HealthPolicy(dead_after=1, reprobe_backoff_s=0.01, seed=seed),
            fault_plan=faults.FaultPlan(plan.to_json()["faults"], seed=0),
        )
        r = rs.get("r0")
        rs.record_failure(r, now=0.0)
        first = r.reprobe_at
        rs.tick(now=first + 1e-4)  # reprobe heartbeat: injected miss
        assert r.state == DEAD
        return first, r.reprobe_at - (first + 1e-4), r.backoff_s

    f1, w1, b1 = windows(seed=3)
    assert b1 == pytest.approx(0.02)  # doubled after the failed reprobe
    assert 0.02 <= w1 < 0.04
    f2, w2, _ = windows(seed=3)
    assert (f1, w1) == (f2, w2)  # per-replica seeded jitter replays
    f3, _, _ = windows(seed=4)
    assert f3 != f1


def test_backoff_schedule_matches_jax():
    """The same failures give the same reprobe windows, state by state, as
    the JAX package's replica set (its seeded per-replica jitter)."""
    from repro.serving import replica as jreplica

    def schedule(mod):
        rs = mod.ReplicaSet(
            [_FakeEngine(), _FakeEngine()],
            policy=mod.HealthPolicy(dead_after=2, reprobe_backoff_s=0.01, seed=7),
        )
        out = []
        for name in ("r0", "r1", "r0", "r1", "r0"):
            r = rs.get(name)
            rs.record_failure(r, now=1.0)
            out.append((name, r.state, r.reprobe_at, r.backoff_s))
        return out

    from repro_torch.serving import replica

    assert schedule(replica) == schedule(jreplica)


def test_rollskip_stale_replica_never_serves():
    rs = ReplicaSet([_FakeEngine(), _FakeEngine()])
    r = rs.get("r1")
    r.stale = True
    assert not r.serveable()
    assert rs.pick(exclude=["r0"]) is None


# ---------------------------------------------------------------------------
# Fault-plan plumbing for the replica sites
# ---------------------------------------------------------------------------
def test_spec_targets_and_site_counts():
    spec = faults.FaultSpec("replica_dispatch", mode="straggle", payload={"replica": "r1"})
    assert faults.spec_targets(spec, "r1")
    assert not faults.spec_targets(spec, "r0")
    assert faults.spec_targets(faults.FaultSpec("replica_dispatch", mode="straggle"), "r0")
    assert not faults.spec_targets(None, "r0")

    plan = faults.FaultPlan([faults.FaultSpec("replica_kill", mode="kill_replica", times=(0,))])
    counts = plan.site_counts()
    assert set(faults.SITES) <= set(counts)
    assert all(v == 0 for v in counts.values())  # zero-filled pre-fire
    plan.fire(faults.REPLICA_KILL)
    assert plan.site_counts()[faults.REPLICA_KILL] == 1
    assert plan.site_counts()[faults.REPLICA_DISPATCH] == 0


# ---------------------------------------------------------------------------
# Router over real replicas
# ---------------------------------------------------------------------------
def test_router_matches_single_engine_bit_for_bit(data):
    q = data[2]
    router = QueryRouter([build_engine(data), build_engine(data)])
    res = run(router, q)
    router.close()
    want = serve_single(build_engine(data), q)
    assert all(isinstance(r, QueryResult) for r in res)
    assert_same(res, want)
    # Both replicas took traffic, every answer is stamped with its server.
    assert {a.replica for a in res} == {"r0", "r1"}
    assert all(a.generation == 0 for a in res)
    assert router.stats.availability == 1.0


def test_router_matches_jax_router(data):
    """The port's router and JAX's, each over two replicas of the same
    index, answer the same queries with the same ids."""
    import jax.numpy as jnp
    from repro.serving import QueryRouter as JRouter
    from repro.serving import RetrievalEngine as JEngine
    from repro.serving import make_backend as jbackend
    from repro.training import checkpoint as jckpt

    q = data[2]

    def jax_engine():
        eng = JEngine(jbackend("lider", None, updatable=True, n_probe=4), batch_size=BATCH,
                      k=K, dim=DIM, params=jckpt.load_index(data[3]))
        eng.warmup()
        return eng

    jrouter = JRouter([jax_engine(), jax_engine()])
    want = run(jrouter, jnp.asarray(q))
    jrouter.close()
    router = QueryRouter([build_engine(data), build_engine(data)])
    res = run(router, q)
    router.close()
    for a, b in zip(res, want):
        np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
        np.testing.assert_allclose(np.asarray(a.scores), np.asarray(b.scores),
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_clone_params_isolates_host_store(data):
    """A clone shares the device leaves and copies the host store: an
    upsert on one replica leaves the other replica's answers unchanged."""
    _, held, q, _ = data
    params = load(data)
    clone = clone_params(params)
    assert clone.bank.gids is params.bank.gids and clone.centroids is params.centroids
    assert clone.bank.store is not params.bank.store
    assert clone.bank.store.rescore.data_ptr() != params.bank.store.rescore.data_ptr()
    assert torch.equal(clone.bank.store.rescore, params.bank.store.rescore)
    a = build_engine(data, params=params)
    b = build_engine(data, params=clone)
    before = serve_single(b, q)
    table = b.params.bank.store.rescore.clone()
    a.apply_updates(upsert_fn(held[:16]))
    assert a.generation == 1 and b.generation == 0
    assert a.params.bank.store.version > 0  # the upsert wrote a's host table
    assert b.params.bank.store.version == 0
    assert torch.equal(b.params.bank.store.rescore, table)
    assert_same(serve_single(b, q), before)
    # The device tier is shared and untouched: a fresh load answers the same.
    assert_same(serve_single(build_engine(data), q), before)


def test_targeted_dispatch_failure_fails_over(data):
    q = data[2]
    plan = faults.FaultPlan(
        [faults.FaultSpec("replica_dispatch", mode="fail", probability=1.0, count=3,
                          payload={"replica": "r0"})],
        seed=1,
    )
    router = QueryRouter([build_engine(data, plan), build_engine(data, plan)], fault_plan=plan)
    res = run(router, q)
    router.close()
    assert all(isinstance(r, QueryResult) for r in res)  # nothing lost
    assert router.stats.n_failovers > 0
    assert router.stats.n_dispatch_failures >= 1
    r0 = router.replicas.get("r0")
    assert r0.n_failures >= 1
    assert r0.state in (SUSPECT, HEALTHY)  # recovered once faults ran out


def test_replica_kill_mid_trace_fails_over_and_stays_dead(data):
    q = data[2]
    plan = faults.FaultPlan(
        [faults.FaultSpec("replica_kill", mode="kill_replica", times=(2,),
                          payload={"replica": "r1"})],
        seed=2,
    )
    router = QueryRouter([build_engine(data, plan), build_engine(data, plan)], fault_plan=plan)
    qs = np.concatenate([q, q * 0.99])
    res = run(router, qs, max_dispatches=1)  # many drain calls -> kill fires
    router.close()
    assert router.stats.n_replica_kills == 1
    r1 = router.replicas.get("r1")
    assert r1.killed and r1.state == DEAD and r1.reprobe_at is None
    assert all(isinstance(r, QueryResult) for r in res)  # zero lost queries
    assert router.stats.availability == 1.0


def test_wrong_generation_guard_discards_and_fails_over(data):
    _, held, q, _ = data
    router = QueryRouter([build_engine(data), build_engine(data)])
    r0 = router.replicas.get("r0")
    orig = r0.engine.execute_chunk
    raced = {"done": False}

    def racy_execute(chunk):
        # An update applied directly to the engine (outside RouterControl)
        # races this in-flight batch: the answer comes back stamped with
        # the new generation while the router dispatched against the old.
        if not raced["done"]:
            raced["done"] = True
            r0.engine.apply_updates(upsert_fn(held[:8]))
        return orig(chunk)

    r0.engine.execute_chunk = racy_execute
    res = run(router, q)
    router.close()
    assert router.stats.n_wrong_generation > 0  # guard tripped...
    assert all(isinstance(r, QueryResult) for r in res)  # ...yet all served
    for a in res:
        assert a.generation == router.replicas.get(a.replica).generation


def test_hedging_rescues_straggler(data):
    q = data[2]
    plan = faults.FaultPlan(
        [faults.FaultSpec("replica_dispatch", mode="straggle", probability=1.0, delay_s=0.25,
                          payload={"replica": "r0"})],
        seed=5,
    )
    cfg = RouterConfig(hedge_quantile=0.5, hedge_min_samples=4)
    router = QueryRouter([build_engine(data, plan), build_engine(data, plan)], config=cfg,
                         fault_plan=plan)
    qs = np.concatenate([q, q * 0.99, q * 1.01])
    res = run(router, qs)
    router.close()
    assert all(isinstance(r, QueryResult) for r in res)
    assert router.stats.n_hedges >= 1
    assert router.stats.n_hedge_wins >= 1  # the hedge beat a 0.25 s straggle
    assert router.stats.n_wrong_generation == 0


def test_rolling_update_zero_downtime_and_bit_identity(data):
    _, held, q, _ = data
    router = QueryRouter([build_engine(data), build_engine(data), build_engine(data)])
    _ = run(router, q)  # pre-roll traffic
    up = upsert_fn(held[:16])
    # Non-blocking roll: traffic keeps flowing while replicas update one at
    # a time behind the mask.
    router.control.apply_updates(up, block=False)
    mixed = run(router, np.concatenate([q, q * 0.99]))
    router.control.wait(timeout=60.0)
    assert router.stats.n_rolls_completed == 1
    assert router.stats.n_roll_replicas_updated == 3
    assert router.generation_window() == (1, 1)  # window closed
    assert all(isinstance(r, QueryResult) for r in mixed)
    assert router.stats.n_wrong_generation == 0

    res = run(router, q)
    router.close()
    single = build_engine(data)
    single.apply_updates(up)
    want = serve_single(single, q)
    assert all(a.generation == 1 for a in res)
    assert_same(res, want)


def test_rolling_update_skips_killed_replica_as_stale(data):
    _, held, q, _ = data
    router = QueryRouter([build_engine(data), build_engine(data), build_engine(data)])
    _ = run(router, q)
    router.replicas.kill("r1")
    router.control.apply_updates(upsert_fn(held[:8]))
    assert router.stats.n_roll_replicas_updated == 2
    assert router.stats.n_roll_replicas_skipped == 1
    r1 = router.replicas.get("r1")
    assert r1.stale and not r1.serveable()  # never rejoins at the old generation
    assert router.generation_window() == (1, 1)
    res = run(router, q)
    router.close()
    assert all(a.generation == 1 for a in res)
    assert {a.replica for a in res} <= {"r0", "r2"}


def test_rolling_update_retries_failed_attempt_once(data):
    # A transiently failing update_fn must be retried, not skipped as stale.
    _, held, q, _ = data
    router = QueryRouter([build_engine(data), build_engine(data)])
    _ = run(router, q)
    up = upsert_fn(held[:8])
    calls = {"n": 0}

    def flaky_up(params):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient update failure")
        return up(params)

    router.control.apply_updates(flaky_up)
    assert router.stats.n_roll_update_failures == 1
    assert router.stats.n_roll_replicas_updated == 2
    assert router.stats.n_roll_replicas_skipped == 0
    assert router.generation_window() == (1, 1)
    assert all(not r.stale and r.serveable() for r in router.replicas)
    res = run(router, q)
    router.close()
    assert all(a.generation == 1 for a in res)


def test_no_serveable_replicas_sheds_structurally(data):
    q = data[2]
    router = QueryRouter([build_engine(data)])
    router.replicas.kill("r0")
    res = run(router, q[:BATCH])
    router.close()
    assert all(isinstance(r, Shed) for r in res)
    assert {r.reason for r in res} == {"no_replica"}
    assert router.stats.availability < 1.0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _counts():
    from repro_torch.kernels import fused_verify as fv, lsh_hash as lh

    return (fv.fused_verify.launches, fv.fused_verify_grouped.launches, lh.lsh_hash.launches)


def _reset():
    from repro_torch.kernels import fused_verify as fv, lsh_hash as lh

    fv.fused_verify.launches = fv.fused_verify_grouped.launches = lh.lsh_hash.launches = 0


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_router_on_the_card_bit_equal_with_exact_launches(card_data):
    """Two replicas on one card (a clone: device leaves shared, host store
    copied), 8 batches through the pool threads: answers == one engine's bit
    for bit, and the launches counted across the threads == the single
    engine's for the same batches."""
    q = np.concatenate([card_data[2]] * 2)
    params = card_data[3]
    single = build_engine(None, params=params)
    _reset()
    want = []
    for i in range(0, len(q), BATCH):
        want += run(single, q[i : i + BATCH])
    single_counts = _counts()
    router = QueryRouter([build_engine(None, params=params),
                          build_engine(None, params=clone_params(params))])
    router.warmup()
    _reset()
    res = []
    for i in range(0, len(q), BATCH):
        res += run(router, q[i : i + BATCH])
    router.close()
    assert _counts() == single_counts and single_counts[0] > 0
    assert {a.replica for a in res} == {"r0", "r1"}
    assert_same(res, want)
    assert router.replicas.get("r0").engine.stream != router.replicas.get("r1").engine.stream


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_router_on_the_card_hedged_and_rolled(card_data):
    """A straggling replica hedged and a rolling upsert on the card: every
    answer == one engine's at its generation, bit for bit."""
    _, held, q, params = card_data
    plan = faults.FaultPlan(
        [faults.FaultSpec("replica_dispatch", mode="straggle", probability=1.0, delay_s=0.1,
                          payload={"replica": "r0"})],
        seed=5,
    )
    router = QueryRouter(
        [build_engine(None, plan, params=clone_params(params)),
         build_engine(None, plan, params=clone_params(params))],
        config=RouterConfig(hedge_quantile=0.5, hedge_min_samples=4), fault_plan=plan)
    qs = np.concatenate([q, q * 0.99, q * 1.01])
    res = run(router, qs)
    assert router.stats.n_hedge_wins >= 1
    assert_same(res, serve_single(build_engine(None, params=params), qs))
    up = upsert_fn(held[:16])
    router.control.apply_updates(up)
    res = run(router, q)
    router.close()
    single = build_engine(None, params=clone_params(params))
    single.apply_updates(up)
    assert all(a.generation == 1 for a in res)
    assert_same(res, serve_single(single, q))
