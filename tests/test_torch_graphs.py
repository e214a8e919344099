"""The query path's graph cache (``repro_torch.core.graphs``) and its counter
``repro_torch.core.lider.query_path_cache_size``.

On the CPU: one sequence of top-level calls runs through both packages on
one JAX-built int8 index (saved by JAX, loaded by the port on either tier)
and each step moves the port's counter by exactly what it moves the JAX
package's ``query_path_cache_size`` (its ``jax.jit`` cache sizes): batch
sizes 2, 4 and 16, two values of ``k``, ``with_stats`` on and off, the
traced ``prune_margin``, a ``block_q`` rung, the host tier's stage pair, the
degraded answer and the engine's padded cluster-major stage 1. One nested
case counts differently and is pinned: a search inside an outer
``jax.jit`` adds no trace to the entries in JAX; the port has no outer
compile, so the same search counts its entry. The rest of the file checks
the cache's own rules: nesting, ``__wrapped__``, traced options, the keys of
bound and persistent tensors, launch counts held during a capture.

The ``gpu`` cases run on the card (no JAX there, so JAX is imported inside
the CPU tests only): a captured search is bit-equal to ``__wrapped__`` on
F32, Q8, Q8-cm, Q4-sk, Q4-sk-cm and the host tier with the same launches a
batch; after a device update a captured search equals the uncaptured one on
the new params; two pipelined batches through one graph keep their own
outputs; a capture that fails raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import graphs, lider, update
from repro_torch.data import synthetic
from repro_torch.kernels import launch
from repro_torch.serving import RetrievalEngine, make_backend
from repro_torch.testing import uncaptured

N, D, K, P = 1000, 32, 10, 4
CFG = dict(n_clusters=8, n_probe=P, kmeans_iters=4)


# ---------------------------------------------------------------------------
# The counter against the JAX package's, step by step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX device- and host-tier params, the port's, queries (32, d))."""
    import jax
    import jax.numpy as jnp

    from repro.core import lider as jlider
    from repro.data import synthetic as jsyn
    from repro.training import checkpoint as jckpt
    from repro_torch.training import checkpoint

    x = np.array(jsyn.retrieval_corpus(0, N, D))
    q = np.array(jsyn.retrieval_queries(1, jnp.asarray(x), 32)[0])
    jp = jlider.build_lider(jax.random.PRNGKey(0), jnp.asarray(x),
                            jlider.LiderConfig(**CFG, storage_dtype="int8"))
    jh = jlider.set_rescore_tier(jp, "host")
    d = str(tmp_path_factory.mktemp("graphs_index"))
    jckpt.save_index(d, jh)
    tp = checkpoint.load_index(d, device="cpu", rescore_tier="device")
    th = checkpoint.load_index(d, device="cpu", rescore_tier="host")
    return (jp, jh), (tp, th), q


def _spelled(L) -> dict:
    """The JAX package keys a trace on the keyword arguments as they are
    spelled (``test_jax_keys_on_the_spelling_of_keywords``), so the stage
    calls spell theirs as its ``search_lider`` does; the port binds the
    defaults and lacks ``use_fused`` and ``block_c``."""
    return {} if L is lider else dict(use_fused=None, block_c=None)


def _steps():
    """(name, fn(lider module, device params, host params, queries)) for
    each step; every fn makes the same top-level calls in either package."""
    kw = dict(n_probe=P, r0=4)

    def search(b, k=K, **extra):
        return lambda L, p, h, q: L.search_lider(p, q[:b], k=k, **kw, **extra)

    def stage1(L, h, q):
        return L.host_first_pass(h, q[:16], k=K, **kw, r0_centroid=4, refine=False,
                                 prune_margin=None, rescore_factor=4, sketch_factor=None,
                                 **_spelled(L))

    def host_pair(L, p, h, q):
        prov, _ = stage1(L, h, q)
        fetched = _asarray(L, L.host_fetch(h, prov.ids))
        return L.host_rescore(h.bank.gids, fetched, prov.ids, q[:16], k=K, **_spelled(L))

    def degraded(L, p, h, q):
        prov, _ = stage1(L, h, q)
        return L.compressed_only_topk(h.bank.gids, prov, k=K)

    def padded_cm_stage1(L, p, h, q):
        return L.host_first_pass_cluster_major(h, q[:16], k=K, block_q=4, stats_out={}, **kw)

    return [
        ("B=2", search(2)),
        ("B=2 again", search(2)),
        ("B=4", search(4)),
        ("B=16", search(16)),
        ("B=16 k=5", search(16, k=5)),
        ("B=16 with_stats", search(16, with_stats=True)),
        ("B=16 prune_margin 0.05", search(16, prune_margin=0.05, with_stats=True)),
        ("B=16 prune_margin 0.1 (traced)", search(16, prune_margin=0.1, with_stats=True)),
        ("B=16 block_q=4", search(16, block_q=4)),
        ("B=16 block_q=4 again", search(16, block_q=4)),
        ("host tier B=16", lambda L, p, h, q: L.search_lider(h, q[:16], k=K, **kw)),
        ("host tier B=16 again", lambda L, p, h, q: L.search_lider(h, q[:16], k=K, **kw)),
        ("host stage pair", host_pair),
        ("degraded answer", degraded),
        ("padded cluster-major stage 1", padded_cm_stage1),
        ("padded cluster-major stage 1 again", padded_cm_stage1),
    ]


def _asarray(L, fetched):
    if L is lider:
        return fetched
    import jax.numpy as jnp

    return jnp.asarray(fetched)


def test_cache_size_deltas_match_jax(both):
    from repro.core import lider as jlider

    (jp, jh), (tp, th), q = both
    qt = torch.from_numpy(q)
    deltas = []
    for name, fn in _steps():
        j0, t0 = jlider.query_path_cache_size(), lider.query_path_cache_size()
        fn(jlider, jp, jh, q)
        fn(lider, tp, th, qt)
        deltas.append((name, jlider.query_path_cache_size() - j0,
                       lider.query_path_cache_size() - t0))
    assert [d[1] for d in deltas] == [d[2] for d in deltas], deltas
    # The steps reach new traces (not only repeats): every entry is seen.
    assert sum(d[1] for d in deltas) >= 12
    assert {n for n, j, _ in deltas if j == 0} >= {"B=2 again", "B=16 block_q=4 again",
                                                   "host tier B=16 again",
                                                   "B=16 prune_margin 0.1 (traced)",
                                                   "padded cluster-major stage 1 again"}
    for name in lider._QUERY_PATH_GRAPHS:
        assert getattr(lider, name).cache_size() > 0, name


def test_search_under_an_outer_jit_is_pinned(both):
    """The one place the counts differ: the JAX quickstart compiles its
    search inside ``jax.jit``, where the entry it reaches adds no trace of
    its own; the port has no outer compile, so its search counts the
    entry once (``examples/quickstart_torch.py``)."""
    import jax

    from repro.core import lider as jlider

    (jp, _), (tp, _), q = both
    j0, t0 = jlider.query_path_cache_size(), lider.query_path_cache_size()
    jax.block_until_ready(jax.jit(lambda x: jlider.search_lider(jp, x, k=7, n_probe=P))(q[:3]).ids)
    lider.search_lider(tp, torch.from_numpy(q[:3]), k=7, n_probe=P)
    assert jlider.query_path_cache_size() - j0 == 0
    assert lider.query_path_cache_size() - t0 == 1


def test_jax_keys_on_the_spelling_of_keywords(both):
    """Pinned: a keyword passed at its default value is a new trace in the
    JAX package and not in the port, which binds the defaults first. The
    steps above spell each entry one way, so the counts agree."""
    from repro.core import lider as jlider

    (_, jh), (_, th), q = both
    for L, h, qq in ((jlider, jh, q[:5]), (lider, th, torch.from_numpy(q[:5]))):
        L.host_first_pass(h, qq, k=K, n_probe=P)
    j0, t0 = jlider.query_path_cache_size(), lider.query_path_cache_size()
    jlider.host_first_pass(jh, q[:5], k=K, n_probe=P, refine=False)
    lider.host_first_pass(th, torch.from_numpy(q[:5]), k=K, n_probe=P, refine=False)
    assert jlider.query_path_cache_size() - j0 == 1
    assert lider.query_path_cache_size() - t0 == 0


# ---------------------------------------------------------------------------
# The cache's rules, on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    x = synthetic.retrieval_corpus(0, N, D, device="cpu")
    q, _ = synthetic.retrieval_queries(1, x, 16)
    p = lider.build_lider(0, x, lider.LiderConfig(**CFG, storage_dtype="int8"), device="cpu")
    return p, q


def test_nested_entries_and_wrapped_count_nothing(small):
    p, q = small
    lider.search_lider(p, q[:5], k=3, n_probe=P)  # _search_lider_device, routing nested
    n = lider.query_path_cache_size()
    route = lider._route_pruned.cache_size()
    lider.search_lider(p, q[:6], k=3, n_probe=P)
    assert lider.query_path_cache_size() == n + 1  # one entry: the nested route adds none
    assert lider._route_pruned.cache_size() == route
    want = lider.search_lider(p, q[:6], k=3, n_probe=P)
    got = lider._search_lider_device.__wrapped__(p, q[:6], k=3, n_probe=P)
    lider._search_lider_device.__wrapped__(p, q[:7], k=3, n_probe=P)  # a new shape, plain
    assert lider.query_path_cache_size() == n + 1
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    with uncaptured():
        lider.search_lider(p, q[:9], k=3, n_probe=P)
    assert lider.query_path_cache_size() == n + 1


def test_traced_option_keys_on_presence_not_value(small):
    p, q = small
    n = lider._route_pruned.cache_size()
    lider._route_pruned(p, q[:3], n_probe=P)
    lider._route_pruned(p, q[:3], n_probe=P, prune_margin=0.01)
    lider._route_pruned(p, q[:3], n_probe=P, prune_margin=0.5)
    lider._route_pruned(p, q[:3], n_probe=P)
    assert lider._route_pruned.cache_size() == n + 2


def test_graph_keys_bind_leaves_and_persistent_inputs(small):
    """A graph is keyed on the address of every tensor it reads in place:
    the index's leaves and persistent inputs; other inputs are copied, so
    only their shape and dtype enter the key."""
    p, q = small
    entry = lider.host_rescore
    gids = p.bank.gids
    fetched = torch.zeros((2, 8, D))
    rows = torch.zeros((2, 8), dtype=torch.int32)

    def key(f, g=gids):
        args = dict(gids=g, fetched=f, prov_rows=rows, queries=q[:2], k=K)
        return entry._graph_key(args, stream=0)

    k1, bound1, copied1 = key(fetched)
    k2, _, _ = key(fetched.clone())
    assert k1 == k2 and len(copied1) == 3 and len(bound1) == 1
    assert bound1[0] is graphs._base(gids)
    assert key(fetched, gids.clone())[0] != k1  # new leaves: a new graph
    buf = graphs.persistent(torch.zeros(64 * D))
    staged = buf[: 16 * D].view(2, 8, D)
    k3, bound3, copied3 = key(staged)
    assert len(copied3) == 2 and bound3[-1] is buf
    assert key(buf[: 16 * D].view(2, 8, D))[0] == k3  # the same buffer: the same graph
    assert entry._graph_key(dict(gids=gids, fetched=fetched, prov_rows=rows, queries=q[:2], k=K),
                            stream=1)[0] != k1  # another engine's stream


def test_signature_holds_no_index_alive(small):
    """A key sees a static object by its type and hash: a host store's
    table is never kept alive by the signatures."""
    p, q = small
    ph = lider.set_rescore_tier(p, "host")
    store = ph.bank.store
    lider.host_first_pass(ph, q[:2], k=K, n_probe=P)
    flat = str(lider.host_first_pass.signatures)
    assert "EmbStore" in flat and "tensor(" not in flat and not any(
        s is store for sig in lider.host_first_pass.signatures for s in _walk(sig))


def _walk(obj):
    yield obj
    if isinstance(obj, tuple):
        for v in obj:
            yield from _walk(v)


def test_fake_tensors_run_plain_and_count_nothing(small):
    from torch._subclasses.fake_tensor import FakeTensorMode

    p, q = small
    n = lider.query_path_cache_size()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq = mode.from_tensor(q[:4])
        out = lider._route_pruned(p, fq, n_probe=P)
    assert tuple(out[0].shape) == (4, P)
    assert lider.query_path_cache_size() == n


def test_launches_counted_at_replay_not_capture():
    class W:
        launches = 0

    w = W()
    with launch.captured_launches() as held:
        launch.count(w, 2)
        launch.count(w, 1)
    assert w.launches == 0 and held == [(w, 2), (w, 1)]
    launch.replayed(held)
    launch.replayed(held)
    assert w.launches == 6
    launch.count(w, 1)  # outside a capture: counted at once
    assert w.launches == 7


def test_engine_on_cpu_has_no_graphs(small):
    p, q = small
    eng = RetrievalEngine(make_backend("lider", None, updatable=True, n_probe=P),
                          batch_size=4, k=K, dim=D, params=p)
    eng.warmup()
    assert eng.graph_bytes == 0 and not graphs.live_graphs()
    n = lider.query_path_cache_size()
    # New device leaves of the same shapes: nothing to capture on the CPU.
    new_leaf = lambda prm: dataclasses.replace(prm, centroids=prm.centroids.clone())  # noqa: E731
    assert not eng.apply_updates(new_leaf)
    assert eng.device_generation == 1 and eng.recompiles == 0
    assert eng.recapture_s == 0.0 and lider.query_path_cache_size() == n


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

POINTS = {  # name: (storage, tier, search options)
    "F32": ("float32", "device", {}),
    "Q8": ("int8", "device", {}),
    "Q8-cm": ("int8", "device", {"block_q": 8}),
    "Q4-sk": ("int4", "device", {"sketch_factor": 2}),
    "Q4-sk-cm": ("int4", "device", {"sketch_factor": 2, "block_q": 8}),
    "host Q8": ("int8", "host", {}),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_index(storage, tier="device", **extra):
    dev = _card()
    x = synthetic.retrieval_corpus(0, 4000, 64, device=dev)
    q, _ = synthetic.retrieval_queries(1, x, 64)
    cfg = lider.LiderConfig(n_clusters=32, n_probe=8, n_arrays=4, n_leaves=4, kmeans_iters=8,
                            storage_dtype=storage, rescore_tier=tier, **extra)
    return x, q, lider.build_lider(0, x, cfg, device=dev)


def _bits(out):
    return out.ids.cpu(), out.scores.cpu().view(torch.int32)


def _counts():
    from repro_torch.kernels import fused_verify as fv, lsh_hash as lh

    return (fv.fused_verify.launches, fv.sketch_prefilter.launches,
            fv.fused_verify_grouped.launches, lh.lsh_hash.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("point", list(POINTS))
def test_captured_search_equals_uncaptured(point):
    storage, tier, opts = POINTS[point]
    _, q, p = _card_index(storage, tier)
    search = lambda qb: lider.search_lider(p, qb, k=10, n_probe=8, r0=8, **opts)  # noqa: E731
    batches = [q[i : i + 16] for i in range(0, 64, 16)]
    with uncaptured():
        c0 = _counts()
        want = [_bits(search(b)) for b in batches]
        torch.cuda.synchronize()
        plain_launches = tuple(a - b for a, b in zip(_counts(), c0))
    first = [_bits(search(b)) for b in batches]  # the first call runs, then captures
    n = lider.query_path_cache_size()
    c0 = _counts()
    got = [_bits(search(b)) for b in batches]  # replays
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), c0)) == plain_launches
    assert lider.query_path_cache_size() == n or "block_q" in opts  # cm: S follows the batch
    assert graphs.live_graphs()
    for w, f, g in zip(want, first, got):
        assert torch.equal(w[0], f[0]) and torch.equal(w[1], f[1])
        assert torch.equal(w[0], g[0]) and torch.equal(w[1], g[1])


@pytest.mark.gpu
def test_captured_search_after_a_device_update_equals_uncaptured():
    x, q, p = _card_index("int8", capacity=1024)
    search = lambda prm: lider.search_lider(prm, q[:16], k=10, n_probe=8, r0=8)  # noqa: E731
    search(p)
    search(p)  # captured on the first leaves
    new, stats = update.upsert(p, q[16:48] * 0.5 + x[:32] * 0.5, route="exact")
    assert not stats.capacity_grew
    n = lider.query_path_cache_size()
    got = _bits(search(new))
    again = _bits(search(new))
    with uncaptured():
        want = _bits(search(new))
        old = _bits(search(p))
    assert lider.query_path_cache_size() == n  # new leaves, known shapes: no new signature
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])
    assert not torch.equal(want[0], old[0])  # the update changed the answers


@pytest.mark.gpu
def test_two_batches_through_one_graph_keep_their_outputs():
    _, q, ph = _card_index("int8", "host")
    kw = dict(k=10, n_probe=8, r0=8)
    a, b = q[:16], q[16:32]
    lider.host_first_pass(ph, a, **kw)
    lider.host_first_pass(ph, a, **kw)  # captured
    prov_a, _ = lider.host_first_pass(ph, a, **kw)  # replay 1
    prov_b, _ = lider.host_first_pass(ph, b, **kw)  # replay 2 of the same graph
    torch.cuda.synchronize()
    with uncaptured():
        want_a, _ = lider.host_first_pass(ph, a, **kw)
        want_b, _ = lider.host_first_pass(ph, b, **kw)
    assert torch.equal(prov_a.ids, want_a.ids) and torch.equal(prov_b.ids, want_b.ids)
    assert not torch.equal(want_a.ids, want_b.ids)
    eng = RetrievalEngine(make_backend("lider", None, updatable=True, n_probe=8, r0=8),
                          batch_size=16, k=10, dim=64, params=ph)
    eng.warmup()
    assert eng.graph_bytes > 0
    rids = [eng.submit(v) for v in q.cpu().numpy()]
    eng.drain()
    out = np.stack([eng.result(r).ids for r in rids])
    with uncaptured():
        want = lider.search_lider(ph, q, **kw)
    np.testing.assert_array_equal(out, want.ids.cpu().numpy())


@pytest.mark.gpu
def test_a_failed_capture_raises():
    dev = _card()

    @graphs.query_path_entry(inputs=("x",))
    def host_synced(x):
        return x * float(x.sum())  # a copy to the host: refused while capturing

    x = torch.ones(8, device=dev)
    try:
        # The first call runs the body, then captures it: the capture raises.
        with pytest.raises(RuntimeError, match="capturing host_synced"):
            host_synced(x)
    finally:
        graphs.ENTRIES.remove(host_synced)
