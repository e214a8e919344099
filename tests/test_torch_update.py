"""The port's index lifecycle (``core.update``, ``bank.grow_bank``) against
the JAX package's, on the same numpy inputs.

JAX-built float32, int8 and int4 indexes are loaded with the port's
``load_index``; the same upsert (exact and learned route, with and
without growth), delete (thresholds 1.0 and 0.0) or growth is applied by
both packages, and the banks must agree leaf for leaf. Tolerances: every
integer leaf, key, code, scale, sketch and row exact; the RMI parameters of
refit clusters to rtol 1e-4 / atol 1e-3 (closed-form float32 fits over
segment sums taken in another order, as in ``test_torch_core.py``).

The port's own lifecycle is held to the JAX contract
(``tests/test_update.py``): build(80%) + upsert(20%) equals build(100%)
with layer 1 frozen, compaction equals a rebuild over the survivors, and a
deleted id never surfaces.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jbank
from repro.core import lider as jlider
from repro.core import update as jupdate
from repro.data import synthetic as jsyn
from repro.training import checkpoint as jckpt
from repro_torch.core import bank, clustering, lider, update
from repro_torch.training import checkpoint

N, D, K, P = 2000, 32, 10, 4
N_BASE = 1600
CFG = dict(n_clusters=16, n_probe=P, kmeans_iters=10)
RMI_RTOL, RMI_ATOL = 1e-4, 1e-3
_RMI_FITS = ("root_w", "root_b", "leaf_w", "leaf_b", "max_err")


@pytest.fixture(scope="module")
def corpus():
    x = np.array(jsyn.retrieval_corpus(0, N, D))
    q = np.array(jsyn.retrieval_queries(1, jnp.asarray(x), 48)[0])
    return x, q


@pytest.fixture(scope="module", params=["float32", "int8", "int4"])
def base_pair(request, corpus, tmp_path_factory):
    """(storage, JAX index over the first 80%, the port's load of it)."""
    sd = request.param
    x, _ = corpus
    jp = jlider.build_lider(
        jax.random.PRNGKey(0), jnp.asarray(x[:N_BASE]), jlider.LiderConfig(**CFG, storage_dtype=sd)
    )
    d = str(tmp_path_factory.mktemp(f"jax_base_{sd}"))
    jckpt.save_index(d, jp)
    return sd, jp, checkpoint.load_index(d, device="cpu")


def _jax_leaves(jp) -> dict[str, np.ndarray]:
    return {
        jckpt._leaf_name(path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]
    }


def _port_leaves(tp) -> dict[str, np.ndarray]:
    return {name: checkpoint._leaf_array(name, t)[0] for name, t in checkpoint.index_leaves(tp)}


def assert_same_index(tp, jp) -> None:
    """The port's index equals JAX's leaf for leaf (fit floats to RMI tol)."""
    got, want = _port_leaves(tp), _jax_leaves(jp)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.split("__")[-1] in _RMI_FITS:
            np.testing.assert_allclose(g, w, rtol=RMI_RTOL, atol=RMI_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _stats(s) -> tuple:
    return (s.n_added, s.n_deleted, s.n_refit, s.capacity, s.capacity_grew)


def test_grow_bank_matches_jax(base_pair):
    """Growth pads keys with the sentinel, positions and gids with -1,
    scales with 1.0 and rows and sketches with zeros, as JAX does."""
    _, jp, tp = base_pair
    cap = tp.capacity + 24
    jg = dataclasses.replace(jp, bank=jbank.grow_bank(jp.bank, cap))
    tg = dataclasses.replace(tp, bank=bank.grow_bank(tp.bank, cap))
    assert tg.capacity == cap
    assert_same_index(tg, jg)
    assert bank.grow_bank(tp.bank, tp.capacity) is tp.bank
    with pytest.raises(ValueError, match="shrink"):
        bank.grow_bank(tp.bank, tp.capacity - 8)


@pytest.mark.parametrize("route", ["exact", "learned"])
def test_upsert_matches_jax(base_pair, corpus, route):
    _, jp, tp = base_pair
    x, _ = corpus
    new = x[N_BASE:]
    ju, js = jupdate.upsert(jp, jnp.asarray(new), route=route)
    tu, ts = update.upsert(tp, new, route=route)
    assert _stats(ts) == _stats(js)
    assert_same_index(tu, ju)
    # The caller's index is left as it was.
    assert int(tp.bank.next_gid) == N_BASE and int(tp.bank.sizes.sum()) == N_BASE


def test_upsert_with_growth_matches_jax(base_pair, corpus):
    """A burst of clones overflows one cluster: Lp grows in pad_multiple
    steps, then the append and refit match."""
    _, jp, tp = base_pair
    x, _ = corpus
    burst = np.tile(x[:1], (tp.capacity + 20, 1))
    ju, js = jupdate.upsert(jp, jnp.asarray(burst), pad_multiple=8)
    tu, ts = update.upsert(tp, burst, pad_multiple=8)
    assert ts.capacity_grew and _stats(ts) == _stats(js)
    assert tu.capacity % 8 == 0 and tu.capacity > tp.capacity
    assert_same_index(tu, ju)


@pytest.mark.parametrize("threshold", [1.0, 0.0])
def test_delete_matches_jax(base_pair, threshold):
    """Tombstones only (1.0), or eager compaction of every touched cluster
    (0.0), with a duplicate and an unknown id in the list."""
    _, jp, tp = base_pair
    rng = np.random.default_rng(7)
    dead = rng.choice(N_BASE, 120, replace=False).astype(np.int32)
    dead = np.concatenate([dead, dead[:3], [N + 50]]).astype(np.int32)
    jd, js = jupdate.delete(jp, jnp.asarray(dead), refit_threshold=threshold)
    td, ts = update.delete(tp, dead, refit_threshold=threshold)
    assert _stats(ts) == _stats(js) and ts.n_deleted == 120
    assert (ts.n_refit > 0) == (threshold == 0.0)
    assert_same_index(td, jd)


def test_delete_then_upsert_matches_jax(base_pair, corpus):
    """Compaction frees slots that a later upsert reuses."""
    _, jp, tp = base_pair
    x, _ = corpus
    dead = np.arange(0, 200, dtype=np.int32)
    jd, _ = jupdate.delete(jp, jnp.asarray(dead), refit_threshold=0.0)
    td, _ = update.delete(tp, dead, refit_threshold=0.0)
    ju, js = jupdate.upsert(jd, jnp.asarray(x[N_BASE : N_BASE + 150]))
    tu, ts = update.upsert(td, x[N_BASE : N_BASE + 150])
    assert _stats(ts) == _stats(js)
    assert_same_index(tu, ju)


# ---------------------------------------------------------------------------
# The port's own lifecycle
# ---------------------------------------------------------------------------


def _frozen(x, storage):
    """Centroids from the 80% base and the capacity the full corpus needs:
    the layer-1-frozen pair of builds of ``tests/test_update.py``."""
    tx = torch.from_numpy(x)
    km = clustering.kmeans(torch.Generator().manual_seed(2), tx[:N_BASE], CFG["n_clusters"], iters=10)
    assign, _ = clustering.assign_chunked(tx, km.centroids)
    cap = lider.padded_capacity(int(torch.bincount(assign.long()).max()), None, 8)
    cfg = lider.LiderConfig(**CFG, capacity=cap, storage_dtype=storage)
    return km.centroids, cfg


_BANK_FIELDS = ("sorted_keys", "sorted_pos", "gids", "sizes", "embs", "next_gid",
                "emb_scales", "rescore_embs", "sketches")


def _assert_banks_equal(a, b, fields=_BANK_FIELDS):
    for f in fields:
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert torch.equal(va, vb), f


@pytest.mark.parametrize("storage", ["float32", "int8", "int4"])
def test_port_upsert_equals_frozen_rebuild(corpus, storage):
    """build(80%) + upsert(20%, two batches) == build(100%), layer 1
    frozen: the same bank, and the same search ids."""
    x, q = corpus
    cen, cfg = _frozen(x, storage)
    base = lider.build_lider(2, x[:N_BASE], cfg, centroids=cen, device="cpu")
    full = lider.build_lider(2, x, cfg, centroids=cen, device="cpu")
    up = base
    for part in np.array_split(x[N_BASE:], 2):
        up, stats = update.upsert(up, part)
        assert not stats.capacity_grew and stats.n_refit >= 1
    _assert_banks_equal(up.bank, full.bank)
    a = lider.search_lider(up, q, k=K, n_probe=P, r0=8)
    b = lider.search_lider(full, q, k=K, n_probe=P, r0=8)
    assert torch.equal(a.ids, b.ids)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_port_compaction_equals_rebuild_over_survivors(corpus, storage):
    """Delete 5% with eager compaction: the bank equals a frozen rebuild
    over the survivors, gids mapped back through the survivor index."""
    x, q = corpus
    cen, cfg = _frozen(x, storage)
    full = lider.build_lider(2, x, cfg, centroids=cen, device="cpu")
    dead = np.sort(np.random.default_rng(5).choice(N, N // 20, replace=False))
    deleted, stats = update.delete(full, dead, refit_threshold=0.0)
    assert stats.n_deleted == len(dead) and stats.n_refit > 0
    assert int(deleted.bank.tombstones.sum()) == 0
    survivors = np.setdiff1d(np.arange(N), dead)
    rebuilt = lider.build_lider(2, x[survivors], cfg, centroids=cen, device="cpu")
    mapped = torch.where(
        rebuilt.bank.gids >= 0,
        torch.from_numpy(survivors.astype(np.int32))[rebuilt.bank.gids.clamp(min=0).long()],
        -1,
    )
    assert torch.equal(deleted.bank.gids, mapped)
    _assert_banks_equal(deleted.bank, rebuilt.bank, [f for f in _BANK_FIELDS if f not in ("gids", "next_gid")])
    a = lider.search_lider(deleted, q, k=K, n_probe=P, r0=8)
    b = lider.search_lider(rebuilt, q, k=K, n_probe=P, r0=8)
    b_ids = torch.where(b.ids >= 0, torch.from_numpy(survivors.astype(np.int32))[b.ids.clamp(min=0).long()], -1)
    assert torch.equal(a.ids, b_ids)


@pytest.mark.parametrize("threshold", [1.0, 0.0])
def test_deleted_ids_never_surface(corpus, threshold):
    x, q = corpus
    p = lider.build_lider(2, x, lider.LiderConfig(**CFG), device="cpu")
    before = lider.search_lider(p, q, k=K, n_probe=P, r0=8)
    dead = torch.unique(before.ids[:, :3].reshape(-1))
    dead = dead[dead >= 0]
    d, stats = update.delete(p, dead, refit_threshold=threshold)
    assert stats.n_deleted == dead.numel()
    assert (stats.n_refit > 0) == (threshold == 0.0)
    after = lider.search_lider(d, q, k=K, n_probe=P, r0=8)
    assert not bool(torch.isin(after.ids, dead).any())
    assert bool((after.ids >= 0).any(dim=-1).all())
    assert update.tombstone_fraction(d.bank).shape == (CFG["n_clusters"],)


def test_update_refuses_the_host_tier_and_a_bad_route(base_pair, corpus):
    """A bad route raises; a float bank refuses the host tier (it has no
    rescore table, as in JAX); a quantized bank on the host tier takes the
    same upsert, delete and growth as on the device tier, its host table
    equal to the device tier's rescore rows (``test_torch_tiered.py`` holds
    the host tier against JAX)."""
    sd, _, tp = base_pair
    x, _ = corpus
    with pytest.raises(ValueError, match="route"):
        update.upsert(tp, x[:4], route="nearest")
    if sd == "float32":
        with pytest.raises(ValueError, match="int8"):
            lider.set_rescore_tier(tp, "host")
        return
    host = lider.set_rescore_tier(tp, "host")
    for step in (lambda p: update.upsert(p, x[N_BASE:])[0],
                 lambda p: update.delete(p, list(range(0, 400, 3)), refit_threshold=0.0)[0],
                 lambda p: dataclasses.replace(p, bank=bank.grow_bank(p.bank, p.capacity + 8))):
        tp, host = step(tp), step(host)
        assert torch.equal(host.bank.store.rescore, tp.bank.rescore_embs)
        assert torch.equal(host.bank.store.gids, tp.bank.gids)
