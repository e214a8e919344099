"""The port's host rescore tier (``bank.EmbStore``, the three-stage tiered
search, its lifecycle and checkpoints) against its own device tier and
against the JAX package.

Tolerances:

- host tier == device tier in the port: ids and scores bit for bit (the
  rescore runs the same ``verify_topk_op`` over the fetched rows), with the
  pruned-probe masks equal;
- the port's host-tier search of a JAX-saved host-tier index against JAX's
  ``search_lider`` on that index: ids exact, scores to rtol 1e-5 / atol
  1e-6 (``repro_torch.testing``: float32 sums in another order);
- host-tier upsert / delete / growth against JAX's on the same index: every
  leaf as ``test_torch_update.py`` holds it (integers, keys, codes, scales,
  sketches and rows exact; refit RMI parameters to rtol 1e-4 / atol 1e-3),
  and the host table and its gid copy exact;
- checkpoints: the port's save of a host-tier index byte-identical to
  JAX's, and each package loading the other's save on either tier;
- a rolled-back transaction leaves the host table, gids and version
  bit-identical.

The JAX side runs on the CPU through its plain versions, as its own tests
run it.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lider as jlider
from repro.core import update as jupdate
from repro.data import synthetic as jsyn
from repro.training import checkpoint as jckpt
from repro_torch import faults
from repro_torch.core import bank, lider, update
from repro_torch.core.bank import EmbStore
from repro_torch.testing import SCORE_ATOL, SCORE_RTOL
from repro_torch.training import checkpoint

N, D, K, P = 2000, 32, 10, 4
N_BASE = 1600
CFG = dict(n_clusters=16, n_probe=P, kmeans_iters=10)
RMI_RTOL, RMI_ATOL = 1e-4, 1e-3
_RMI_FITS = ("root_w", "root_b", "leaf_w", "leaf_b", "max_err")
SEARCHES = {
    "plain": {},
    "pruned": {"prune_margin": 0.05},
    "block_q8": {"block_q": 8},
    "sketch2": {"sketch_factor": 2},
    "sketch2_block_q4": {"sketch_factor": 2, "block_q": 4},
}


@pytest.fixture(scope="module")
def corpus():
    x = np.array(jsyn.retrieval_corpus(0, N, D))
    q = np.array(jsyn.retrieval_queries(1, jnp.asarray(x), 48)[0])
    return x, q


@pytest.fixture(scope="module", params=["int8", "int4"])
def saved(request, corpus, tmp_path_factory):
    """(storage, directory of JAX's host-tier save of a JAX-built index over
    the first 80% of the corpus)."""
    sd = request.param
    x, _ = corpus
    jp = jlider.build_lider(
        jax.random.PRNGKey(0), jnp.asarray(x[:N_BASE]), jlider.LiderConfig(**CFG, storage_dtype=sd)
    )
    d = str(tmp_path_factory.mktemp(f"jax_host_{sd}"))
    jckpt.save_index(d, jlider.set_rescore_tier(jp, "host"))
    return sd, d


def _port(d, tier=None):
    return checkpoint.load_index(d, device="cpu", rescore_tier=tier)


def _search(p, q, **kw):
    return lider.search_lider(p, q, k=K, n_probe=P, r0=4, **kw)


def _assert_bit_parity(pd, ph, q, **kw):
    a, b = _search(pd, q, with_stats=True, **kw), _search(ph, q, with_stats=True, **kw)
    assert torch.equal(a[0].ids, b[0].ids)
    assert torch.equal(a[0].scores, b[0].scores)
    assert torch.equal(a[1], b[1])


def _jax_leaves(jp) -> dict[str, np.ndarray]:
    return {jckpt._leaf_name(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}


def assert_same_host_index(tp, jp) -> None:
    """The port's host-tier index equals JAX's leaf for leaf, and the host
    tables and their gid copies are equal."""
    got = {n: checkpoint._leaf_array(n, t)[0] for n, t in checkpoint.index_leaves(tp)}
    got_table = got.pop("bank__rescore_embs")
    want = _jax_leaves(jp)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.split("__")[-1] in _RMI_FITS:
            np.testing.assert_allclose(g, w, rtol=RMI_RTOL, atol=RMI_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got_table, jp.bank.store.rescore)
    np.testing.assert_array_equal(tp.bank.store.gids.numpy(), jp.bank.store.gids)
    assert tp.bank.store.shape == jp.bank.store.shape


# ---------------------------------------------------------------------------
# Tier plumbing and accounting
# ---------------------------------------------------------------------------


def test_tier_properties_and_store_shape(saved):
    _, d = saved
    pd, ph = _port(d, "device"), _port(d)
    assert pd.bank.rescore_tier == "device" and ph.bank.rescore_tier == "host"
    assert ph.bank.rescore_embs is None
    assert ph.bank.store.shape == tuple(pd.bank.rescore_embs.shape)
    assert ph.bank.store.rescore.is_contiguous() and ph.bank.store.rescore.device.type == "cpu"
    assert torch.equal(ph.bank.store.rescore, pd.bank.rescore_embs)
    assert torch.equal(ph.bank.store.gids, ph.bank.gids)  # the synced gid copy


def test_nbytes_by_tier_accounting(saved):
    _, d = saved
    pd, ph = _port(d, "device"), _port(d)
    dev, host = pd.bank.nbytes_by_tier(), ph.bank.nbytes_by_tier()
    assert dev["host"] == 0
    assert host["host"] == pd.bank.rescore_embs.numel() * 4
    assert dev["device"] - host["device"] == host["host"]


def test_direct_host_build_matches_conversion(corpus):
    x, q = corpus
    cfg = lider.LiderConfig(**CFG, storage_dtype="int8")
    built = lider.build_lider(0, x, dataclasses.replace(cfg, rescore_tier="host"), device="cpu")
    assert built.bank.rescore_tier == "host"
    converted = lider.set_rescore_tier(lider.build_lider(0, x, cfg, device="cpu"), "host")
    assert torch.equal(built.bank.store.rescore, converted.bank.store.rescore)
    _assert_bit_parity(built, converted, q)


def test_host_tier_requires_a_quantized_bank(corpus):
    x, _ = corpus
    cfg = lider.LiderConfig(**CFG, storage_dtype="float32", rescore_tier="host")
    with pytest.raises(ValueError, match="int8"):
        lider.build_lider(0, x, cfg, device="cpu")
    p32 = lider.build_lider(0, x, dataclasses.replace(cfg, rescore_tier="device"), device="cpu")
    with pytest.raises(ValueError, match="int8|rescore"):
        lider.set_rescore_tier(p32, "host")
    with pytest.raises(ValueError, match="rescore_tier"):
        lider.set_rescore_tier(p32, "disk")


def test_incluster_search_rejects_host_tier(saved, corpus):
    _, d = saved
    _, q = corpus
    cids = torch.zeros((q.shape[0], 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="host-tier"):
        lider.incluster_search(_port(d), torch.from_numpy(q), cids, k=K)


def test_embstore_hash_is_content_stable(saved):
    _, d = saved
    st = _port(d).bank.store
    before = hash(st)
    st.write_rows(torch.tensor([0]), st.fetch(torch.tensor([0])))
    assert hash(st) == before and st.version == 1
    other = EmbStore(torch.zeros(st.shape))  # same shape, other content
    assert other == st and hash(other) == hash(st) and other.tier == "host"
    assert other != EmbStore(torch.zeros((1,) + st.shape[1:]))


def test_fetch_gathers_rows_and_pads_with_row_zero(saved):
    """``fetch`` is a gather of flat rows (negative rows read row 0), into
    a given buffer too; ``take_gids`` maps rows through the gid copy."""
    _, d = saved
    st = _port(d).bank.store
    table = st.rescore.reshape(-1, st.shape[-1])
    rows = torch.tensor([[3, -1, 7], [0, 11, -1]], dtype=torch.int32)
    want = table[rows.clamp(min=0).long()]
    assert torch.equal(st.fetch(rows), want)
    buf = torch.full((8, st.shape[-1]), 7.0)
    got = st.fetch(rows, out=buf)
    assert torch.equal(got, want) and got.data_ptr() == buf.data_ptr()
    gids = st.take_gids(rows)
    assert torch.equal(gids[rows < 0], torch.full((2,), -1, dtype=torch.int32))
    assert torch.equal(gids[rows >= 0], st.gids.reshape(-1)[rows[rows >= 0].long()])


# ---------------------------------------------------------------------------
# Search: host tier == device tier, and == JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_host_tier_equals_device_tier_bit_for_bit(saved, corpus, name):
    _, d = saved
    _, q = corpus
    _assert_bit_parity(_port(d, "device"), _port(d), q, **SEARCHES[name])


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_host_search_of_jax_saved_index_matches_jax(saved, corpus, name):
    _, d = saved
    _, q = corpus
    jph = jckpt.load_index(d)
    assert jph.bank.rescore_tier == "host"
    kw = dict(k=K, n_probe=P, r0=4, with_stats=True, **SEARCHES[name])
    jo, jpr = jlider.search_lider(jph, jnp.asarray(q), **kw)
    to, tpr = lider.search_lider(_port(d), q, **kw)
    np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
    np.testing.assert_allclose(to.scores.numpy(), np.asarray(jo.scores), rtol=SCORE_RTOL, atol=SCORE_ATOL)
    np.testing.assert_array_equal(tpr.numpy(), np.asarray(jpr))


def test_staged_stages_match_jax(saved, corpus):
    """Stage 1 (provisional rows, code-domain scores) bit-exact against
    JAX's; the fetched block equal; the compressed-only answer's ids equal."""
    _, d = saved
    _, q = corpus
    jph, tph = jckpt.load_index(d), _port(d)
    jprov, _ = jlider.host_first_pass(jph, jnp.asarray(q), k=K, n_probe=P)
    tprov, _ = lider.host_first_pass(tph, torch.from_numpy(q), k=K, n_probe=P)
    np.testing.assert_array_equal(tprov.ids.numpy(), np.asarray(jprov.ids))
    np.testing.assert_array_equal(tprov.scores.numpy(), np.asarray(jprov.scores))
    np.testing.assert_array_equal(
        lider.host_fetch(tph, tprov.ids).numpy(), jlider.host_fetch(jph, jprov.ids)
    )
    jdeg = jlider.compressed_only_topk(jph.bank.gids, jprov, k=K)
    tdeg = lider.compressed_only_topk(tph.bank.gids, tprov, k=K)
    np.testing.assert_array_equal(tdeg.ids.numpy(), np.asarray(jdeg.ids))
    np.testing.assert_array_equal(tdeg.scores.numpy(), np.asarray(jdeg.scores))


def test_per_pair_provisional_rows_match_jax(saved, corpus):
    _, d = saved
    _, q = corpus
    jph, tph = jckpt.load_index(d), _port(d)
    cids = np.array(jlider.route_queries(jph, jnp.asarray(q), n_probe=P).ids)
    jo = jlider.provisional_rows(jph, jnp.asarray(q), jnp.asarray(cids), k=K, merge=False)
    to = lider.provisional_rows(tph, torch.from_numpy(q), torch.from_numpy(cids), k=K, merge=False)
    assert to.ids.shape == (q.shape[0], P, 4 * K)
    np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
    np.testing.assert_array_equal(to.scores.numpy(), np.asarray(jo.scores))


# ---------------------------------------------------------------------------
# Lifecycle on the host tier
# ---------------------------------------------------------------------------


def test_host_lifecycle_matches_jax_and_the_device_tier(saved, corpus):
    """Upsert (growing Lp) -> tombstones -> compaction on the host tier,
    applied to JAX's host-tier index and the port's: leaf for leaf and host
    table for host table at every stage; the port's host tier also stays
    bit-identical in search to its device tier taking the same updates."""
    _, d = saved
    x, q = corpus
    jh, th, td = jckpt.load_index(d), _port(d), _port(d, "device")
    burst = np.concatenate([x[N_BASE:], np.tile(x[:1], (th.capacity + 8, 1))])
    jh, js = jupdate.upsert(jh, jnp.asarray(burst))
    th, ts = update.upsert(th, burst)
    td, _ = update.upsert(td, burst)
    assert ts.capacity_grew and js.capacity_grew and ts.capacity == js.capacity
    assert_same_host_index(th, jh)
    assert torch.equal(th.bank.store.rescore, td.bank.rescore_embs)
    _assert_bit_parity(td, th, q)
    for dead, threshold in ((np.arange(50, 150), 1.0), (np.arange(200, 260), 0.0)):
        jh, js = jupdate.delete(jh, jnp.asarray(dead, jnp.int32), refit_threshold=threshold)
        th, ts = update.delete(th, dead, refit_threshold=threshold)
        td, _ = update.delete(td, dead, refit_threshold=threshold)
        assert (ts.n_deleted, ts.n_refit) == (js.n_deleted, js.n_refit)
        assert_same_host_index(th, jh)
        assert torch.equal(th.bank.store.rescore, td.bank.rescore_embs)
        _assert_bit_parity(td, th, q)
        assert not np.isin(_search(th, q).ids.numpy(), dead).any()
    assert ts.n_refit > 0  # the second delete compacted


def test_grow_bank_grows_the_store_copy_on_grow(saved):
    _, d = saved
    th = _port(d)
    grown = bank.grow_bank(th.bank, th.capacity + 16)
    assert grown.store is not th.bank.store
    assert grown.store.shape == (th.n_clusters, th.capacity + 16, D)
    assert torch.equal(grown.store.rescore[:, : th.capacity], th.bank.store.rescore)
    assert not grown.store.rescore[:, th.capacity:].any()
    assert bool((grown.store.gids[:, th.capacity:] == -1).all())
    assert grown.store.version == th.bank.store.version + 1
    assert bank.grow_bank(th.bank, th.capacity).store is th.bank.store


def test_growth_preserves_pre_growth_snapshot(corpus):
    """Growth is copy-on-grow: a retained pre-growth index keeps its own
    store and searches exactly as before."""
    x, q = corpus
    cfg = lider.LiderConfig(**CFG, storage_dtype="int8", rescore_tier="host")
    snap = lider.build_lider(0, x[:N_BASE], cfg, device="cpu")
    before = _search(snap, q)
    grown, stats = update.upsert(snap, np.tile(x[:1], (snap.capacity + 8, 1)))
    assert stats.capacity_grew
    assert grown.bank.store is not snap.bank.store
    assert snap.bank.store.shape[1] == snap.capacity
    after = _search(snap, q)
    assert torch.equal(before.ids, after.ids) and torch.equal(before.scores, after.scores)


def test_round_trip_tier_conversion_is_lossless(saved, corpus):
    _, d = saved
    _, q = corpus
    pd = _port(d, "device")
    back = lider.set_rescore_tier(lider.set_rescore_tier(pd, "host"), "device")
    assert torch.equal(back.bank.rescore_embs, pd.bank.rescore_embs)
    _assert_bit_parity(pd, back, q)


def _small_store():
    rng = np.random.default_rng(0)
    return EmbStore(
        rng.standard_normal((4, 6, 3)).astype(np.float32),
        gids=rng.integers(0, 100, (4, 6)).astype(np.int32),
    )


def test_embstore_rollback_restores_bytes_gids_version():
    store = _small_store()
    before, gids_before, v0 = store.rescore.clone(), store.gids.clone(), store.version
    store.begin_txn()
    assert store.in_txn
    store.write_rows(np.array([0, 7, 13]), np.ones((3, 3), np.float32))
    store.sync_gids(np.full((4, 6), 9, np.int32))
    store.compact_clusters(np.array([1]), np.array([[3, -1, 5, -1, -1, -1]]))
    store.write_rows(np.array([7]), np.full((1, 3), 2.0, np.float32))
    assert not torch.equal(store.rescore, before)
    store.rollback()
    assert torch.equal(store.rescore, before)
    assert torch.equal(store.gids, gids_before)
    assert store.version == v0 and not store.in_txn


def test_embstore_commit_keeps_writes_and_txn_misuse_raises():
    store = _small_store()
    store.begin_txn()
    with pytest.raises(RuntimeError):
        store.begin_txn()  # nested transactions are a bug
    store.write_rows(np.array([2]), np.full((1, 3), 5.0, np.float32))
    store.commit()
    assert store.rescore.reshape(-1, 3)[2][0] == 5.0
    for op in (store.commit, store.rollback):
        with pytest.raises(RuntimeError):
            op()  # no open transaction


def test_failed_upsert_rolls_back_the_host_table(saved, corpus):
    """An upsert that fails after its host write (the ``host_write`` fault
    site) inside a transaction leaves the table, gids and version as they
    were, bit for bit."""
    _, d = saved
    x, _ = corpus
    th = _port(d)
    # Room for the upsert, so it writes this store in place (growth would
    # write a new one).
    th = dataclasses.replace(th, bank=bank.grow_bank(th.bank, th.capacity + 64))
    st = th.bank.store
    before, gids_before, v0 = st.rescore.clone(), st.gids.clone(), st.version
    plan = faults.FaultPlan([faults.FaultSpec("host_write", mode="error", times=(0,))])
    st.begin_txn()
    with pytest.raises(faults.InjectedFault), faults.activate(plan):
        update.upsert(th, x[N_BASE : N_BASE + 32])
    assert not torch.equal(st.rescore, before)  # the write happened...
    st.rollback()  # ...and is undone
    assert torch.equal(st.rescore, before) and torch.equal(st.gids, gids_before)
    assert st.version == v0


# ---------------------------------------------------------------------------
# Checkpoints across tiers and packages
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_across_tiers(saved, corpus, tmp_path):
    _, d = saved
    _, q = corpus
    pd, ph = _port(d, "device"), _port(d)
    checkpoint.save_index(str(tmp_path / "h"), ph)
    as_host = _port(str(tmp_path / "h"))
    as_dev = _port(str(tmp_path / "h"), "device")
    assert as_host.bank.rescore_tier == "host" and as_dev.bank.rescore_tier == "device"
    _assert_bit_parity(pd, as_host, q)
    _assert_bit_parity(pd, as_dev, q)
    checkpoint.save_index(str(tmp_path / "d"), pd)
    cross = _port(str(tmp_path / "d"), "host")
    assert cross.bank.rescore_tier == "host"
    _assert_bit_parity(pd, cross, q)


def test_checkpoint_rejects_host_tier_for_float(corpus, tmp_path):
    x, _ = corpus
    p32 = lider.build_lider(0, x, lider.LiderConfig(**CFG), device="cpu")
    checkpoint.save_index(str(tmp_path), p32)
    with pytest.raises(ValueError, match="int8"):
        _port(str(tmp_path), "host")


def test_port_save_of_host_tier_index_is_byte_identical_to_jax(saved, tmp_path):
    _, d = saved
    path = checkpoint.save_index(str(tmp_path), _port(d))
    want = sorted(os.listdir(os.path.join(d, "index")))
    assert sorted(os.listdir(path)) == want
    for name in want:
        with open(os.path.join(d, "index", name), "rb") as a, open(os.path.join(path, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("tier", ["host", "device"])
def test_jax_loads_the_ports_host_tier_save(saved, corpus, tmp_path, tier):
    """The port updates its host-tier index and saves it; JAX loads it on
    either tier and its search returns the port's ids."""
    _, d = saved
    x, q = corpus
    th, _ = update.upsert(_port(d), x[N_BASE:])
    checkpoint.save_index(str(tmp_path), th)
    jp = jckpt.load_index(str(tmp_path), rescore_tier=tier)
    assert jp.bank.rescore_tier == tier
    jo = jlider.search_lider(jp, jnp.asarray(q), k=K, n_probe=P)
    to = _search(th, q)
    np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
    np.testing.assert_allclose(to.scores.numpy(), np.asarray(jo.scores), rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_port_loads_a_jax_device_tier_save_as_host(corpus, tmp_path):
    x, q = corpus
    jp = jlider.build_lider(
        jax.random.PRNGKey(1), jnp.asarray(x), jlider.LiderConfig(**CFG, storage_dtype="int8")
    )
    jckpt.save_index(str(tmp_path), jp)
    th = _port(str(tmp_path), "host")
    assert th.bank.rescore_tier == "host"
    np.testing.assert_array_equal(th.bank.store.rescore.numpy(), np.asarray(jp.bank.rescore_embs))
    jo = jlider.search_lider(jp, jnp.asarray(q), k=K, n_probe=P)
    to = _search(th, q)
    np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
    np.testing.assert_allclose(to.scores.numpy(), np.asarray(jo.scores), rtol=SCORE_RTOL, atol=SCORE_ATOL)
