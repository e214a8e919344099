"""The port's core modules (utils, lsh, rescale, rmi, core model,
clustering, bank refit, flat search) against the JAX package, on the same
numpy inputs and, where the JAX side draws random numbers, with its draws
(projections, centroids) handed to the port.

Tolerances: integer outputs (keys, orders, assignments, slots, ids) exact;
float32 outputs that come from sums taken in another order (RMI fits,
k-means sums, scores) to rtol 1e-5 / atol 1e-6 unless stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jbank
from repro.core import clustering as jclust
from repro.core import core_model as jcm
from repro.core import lsh as jlsh
from repro.core import rescale as jresc
from repro.core import rmi as jrmi
from repro.core import utils as jutils
from repro.core.baselines import flat_search as jflat
from repro_torch.core import bank, clustering, core_model, lsh, rescale, rmi, utils
from repro_torch.core.baselines import flat_search
from repro_torch.testing import SCORE_ATOL, SCORE_RTOL, assert_topk_match

RMI_RTOL, RMI_ATOL = 1e-4, 1e-3  # closed-form f32 fits over segment sums


def _unit(rng, n, d, modes=8, spread=0.4):
    centers = rng.standard_normal((modes, d))
    x = centers[rng.integers(0, modes, n)] + spread * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 40])
def test_dedup_topk_matches_jax(k):
    rng = np.random.default_rng(k)
    ids = rng.integers(-1, 12, (6, 30)).astype(np.int32)
    table = rng.standard_normal(12).astype(np.float32)
    table[3] = table[7]  # a score tie between distinct ids
    scores = np.where(ids >= 0, table[np.maximum(ids, 0)], 0).astype(np.float32)
    gi, gs = utils.dedup_topk(_t(ids), _t(scores), k)
    wi, ws = jutils.dedup_topk(jnp.asarray(ids), jnp.asarray(scores), k)
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gs.numpy(), _np(ws))


def test_merge_topk_recall_mrr_normalize():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, (4, 3, 5)).astype(np.int32)
    sc = rng.standard_normal((4, 3, 5)).astype(np.float32)
    sc = np.take_along_axis(sc, np.argsort(-sc, -1), -1)
    gi, gs = utils.merge_topk(_t(ids), _t(sc), 6)
    wi, ws = jutils.merge_topk(jnp.asarray(ids), jnp.asarray(sc), 6)
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gs.numpy(), _np(ws))
    true = rng.integers(-1, 50, (4, 6)).astype(np.int32)
    assert float(utils.recall_at_k(gi, _t(true))) == pytest.approx(
        float(jutils.recall_at_k(wi, jnp.asarray(true))), abs=1e-7
    )
    assert utils.mrr_at_10(gi.numpy(), true[:, 0]) == jutils.mrr_at_10(_np(wi), true[:, 0])
    x = rng.standard_normal((5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        utils.l2_normalize(_t(x)).numpy(), _np(jutils.l2_normalize(jnp.asarray(x))),
        rtol=SCORE_RTOL, atol=SCORE_ATOL,
    )


# ---------------------------------------------------------------------------
# lsh, rescale, rmi
# ---------------------------------------------------------------------------


def test_hash_bits_flip_rate_with_shared_projections():
    """Hash bits are signs of an f32 product: measure how many flip between
    XLA and torch on the same projections. Expected 0 at this size; the
    bound only trips on a systematic difference (wrong packing or order)."""
    rng = np.random.default_rng(1)
    x = _unit(rng, 3000, 64)
    proj = rng.standard_normal((64, 10 * 16)).astype(np.float32)
    jp = jlsh.LSHParams(projections=jnp.asarray(proj), n_arrays=10, key_len=16)
    tp = lsh.LSHParams(projections=_t(proj), n_arrays=10, key_len=16)
    jk = _np(jlsh.hash_vectors(jp, jnp.asarray(x))).astype(np.int64)
    tk = lsh.hash_vectors(tp, _t(x)).numpy()
    flipped = sum(bin(int(v)).count("1") for v in np.bitwise_xor(jk, tk).ravel())
    rate = flipped / (jk.size * 16)
    assert rate <= 1e-4, f"bit flip rate {rate}"
    assert np.mean(jk == tk) >= 0.999


def test_pad_sentinel_sorts_last_and_sort_is_stable():
    keys = np.array([[5, 3, 5, 0, 3, 7]], dtype=np.uint32)
    valid = np.array([[True, True, True, False, True, False]])
    jk = jlsh.mask_padded(jnp.asarray(keys), jnp.asarray(valid))
    js, jo = jlsh.sort_hashkeys(jk)
    tk = lsh.mask_padded(_t(keys.astype(np.int64)), _t(valid))
    ts, to = lsh.sort_hashkeys(tk)
    np.testing.assert_array_equal(ts.numpy(), _np(js).astype(np.int64))
    np.testing.assert_array_equal(to.numpy(), _np(jo))
    assert ts[0, -1] == lsh.UINT32_PAD and lsh.suggest_key_len(1000) == jlsh.suggest_key_len(1000)


def test_rescale_matches_jax():
    rng = np.random.default_rng(2)
    keys = np.sort(rng.integers(0, 2**16, (4, 50)).astype(np.uint32), axis=-1)
    valid = np.arange(50)[None, :] < np.array([[50], [30], [1], [0]])
    keys = np.where(valid, keys, np.uint32(jlsh.UINT32_PAD))
    keys = np.sort(keys, axis=-1)
    queries = rng.integers(0, 2**16, (4, 9)).astype(np.uint32)
    jr = jax.vmap(jresc.fit_rescale)(jnp.asarray(keys), jnp.asarray(valid))
    jout = jax.vmap(jresc.rescale)(jr, jnp.asarray(queries))
    tr = rescale.fit_rescale(_t(keys.astype(np.int64)), _t(valid))
    tout = rescale.rescale(tr.unsqueeze(-1), _t(queries.astype(np.int64)))
    np.testing.assert_array_equal(tr.key_min.numpy(), _np(jr.key_min).astype(np.int64))
    np.testing.assert_array_equal(tr.key_max.numpy(), _np(jr.key_max).astype(np.int64))
    np.testing.assert_array_equal(tr.length.numpy(), _np(jr.length))
    np.testing.assert_array_equal(tout.numpy(), _np(jout))


def test_fit_rmi_and_predict_match_jax():
    rng = np.random.default_rng(3)
    n_valid = np.array([200, 120, 3, 0])
    keys = np.sort(rng.random((4, 200)).astype(np.float32) * 199, axis=-1)
    w = (np.arange(200)[None, :] < n_valid[:, None]).astype(np.float32)
    keys = np.where(w > 0, keys, 199.0).astype(np.float32)
    jr = jax.vmap(lambda x, ww: jrmi.fit_rmi(x, ww, n_leaves=5))(jnp.asarray(keys), jnp.asarray(w))
    tr = rmi.fit_rmi(_t(keys), _t(w), n_leaves=5)
    for f in ("root_w", "root_b", "leaf_w", "leaf_b", "length", "max_err"):
        np.testing.assert_allclose(
            getattr(tr, f).numpy(), _np(getattr(jr, f)), rtol=RMI_RTOL, atol=RMI_ATOL, err_msg=f
        )
    # Prediction on the SAME parameters is elementwise: held exactly.
    x = (rng.random((4, 17)) * 199).astype(np.float32)
    jp = jax.vmap(jrmi.predict)(jr, jnp.asarray(x))
    same = rmi.RMIParams(
        **{f: _t(_np(getattr(jr, f))) for f in ("root_w", "root_b", "leaf_w", "leaf_b", "length", "max_err")},
        n_leaves=5,
    )
    np.testing.assert_array_equal(rmi.predict(same, _t(x)).numpy(), _np(jp))


# ---------------------------------------------------------------------------
# core model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def core_pair():
    rng = np.random.default_rng(4)
    x = _unit(rng, 1500, 32)
    q = _unit(rng, 40, 32)
    jm = jcm.build_core_model(jax.random.PRNGKey(0), jnp.asarray(x), n_arrays=6, key_len=11, n_leaves=8)
    proj = _np(jm.lsh.projections)
    tm = core_model.fit_core_model(
        lsh.LSHParams(projections=_t(proj), n_arrays=6, key_len=11), _t(x), n_leaves=8
    )
    return x, q, jm, tm


def test_core_model_build_matches_jax(core_pair):
    _, _, jm, tm = core_pair
    np.testing.assert_array_equal(tm.sorted_keys.numpy(), _np(jm.sorted_keys).astype(np.int64))
    np.testing.assert_array_equal(tm.sorted_ids.numpy(), _np(jm.sorted_ids))
    for f in ("root_w", "root_b", "leaf_w", "leaf_b", "length", "max_err"):
        np.testing.assert_allclose(
            getattr(tm.rmi, f).numpy(), _np(getattr(jm.rmi, f)), rtol=RMI_RTOL, atol=RMI_ATOL
        )


@pytest.mark.parametrize("refine", [False, True], ids=["rmi", "refine"])
def test_core_model_search_matches_jax(core_pair, refine):
    x, q, jm, tm = core_pair
    jo = jcm.search_core_model(jm, jnp.asarray(x), jnp.asarray(q), k=10, r0=4, refine=refine)
    to = core_model.search_core_model(tm, _t(x), _t(q), k=10, r0=4, refine=refine)
    assert_topk_match(to.ids, to.scores, _np(jo.ids), _np(jo.scores))


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------


def test_assign_and_kmeans_step_match_jax_given_centroids():
    rng = np.random.default_rng(5)
    x = _unit(rng, 2000, 32)
    cen = x[rng.choice(2000, 16, replace=False)]
    ja, jd = jclust.assign_chunked(jnp.asarray(x), jnp.asarray(cen), chunk=512)
    ta, td = clustering.assign_chunked(_t(x), _t(cen), chunk=512)
    np.testing.assert_array_equal(ta.numpy(), _np(ja))
    np.testing.assert_allclose(td.numpy(), _np(jd), rtol=SCORE_RTOL, atol=SCORE_ATOL)
    js, jc, jass = jclust.kmeans_step(jnp.asarray(x), jnp.asarray(cen), n_clusters=16)
    ts, tc, tass = clustering.kmeans_step(_t(x), _t(cen), n_clusters=16)
    np.testing.assert_array_equal(tass.numpy(), _np(jass))
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=SCORE_RTOL, atol=1e-5)
    np.testing.assert_allclose(
        clustering.update_centroids(_t(cen), ts, tc).numpy(),
        _np(jclust.update_centroids(jnp.asarray(cen), js, jc)),
        rtol=SCORE_RTOL, atol=SCORE_ATOL,
    )


@pytest.mark.parametrize("capacity", [300, 90], ids=["fits", "drops"])
def test_group_by_cluster_matches_jax(capacity):
    rng = np.random.default_rng(6)
    assign = rng.integers(0, 12, 1000).astype(np.int32)
    jg, js = jclust.group_by_cluster(jnp.asarray(assign), 12, capacity)
    tg, ts = clustering.group_by_cluster(_t(assign), 12, capacity)
    np.testing.assert_array_equal(tg.numpy(), _np(jg))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


def test_kmeans_port_runs_and_init_draws_distinct_points():
    rng = np.random.default_rng(7)
    x = _t(_unit(rng, 800, 16))
    g = torch.Generator().manual_seed(0)
    cen = clustering.init_centroids(g, x, 20)
    assert torch.unique(cen, dim=0).shape[0] == 20
    res = clustering.kmeans(torch.Generator().manual_seed(0), x, 8, iters=5)
    assert res.centroids.shape == (8, 16) and res.assignment.dtype == torch.int32
    with pytest.raises(ValueError, match="distinct"):
        clustering.init_centroids(g, x[:3], 4)


# ---------------------------------------------------------------------------
# bank refit
# ---------------------------------------------------------------------------


def test_refit_all_clusters_matches_jax_given_projections(monkeypatch):
    rng = np.random.default_rng(8)
    x = _unit(rng, 1200, 32)
    assign = rng.integers(0, 10, 1200).astype(np.int32)
    jg, _ = jclust.group_by_cluster(jnp.asarray(assign), 10, 160)
    rows = _np(jbank.gather_cluster_rows(jnp.asarray(x), jg))
    valid = _np(jg) >= 0
    proj = rng.standard_normal((32, 8 * 12)).astype(np.float32)
    jl = jlsh.LSHParams(projections=jnp.asarray(proj), n_arrays=8, key_len=12)
    jk, jp, jres, jr = jbank._fit_all_clusters(jl, jnp.asarray(rows), jnp.asarray(valid), n_leaves=5)
    tl = lsh.LSHParams(projections=_t(proj), n_arrays=8, key_len=12)
    monkeypatch.setattr(bank, "_FIT_CHUNK", 3)  # 10 clusters over 4 chunks, the last partial
    tk, tp, tres, tr = bank.fit_clusters(tl, _t(rows), _t(valid), n_leaves=5)
    np.testing.assert_array_equal(
        bank.gather_cluster_rows(_t(x), _t(_np(jg))).numpy(), rows
    )
    np.testing.assert_array_equal(tk.numpy(), _np(jk).astype(np.int64))
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    np.testing.assert_array_equal(tres.key_min.numpy(), _np(jres.key_min).astype(np.int64))
    np.testing.assert_array_equal(tres.key_max.numpy(), _np(jres.key_max).astype(np.int64))
    for f in ("root_w", "root_b", "leaf_w", "leaf_b", "length", "max_err"):
        np.testing.assert_allclose(
            getattr(tr, f).numpy(), _np(getattr(jr, f)), rtol=RMI_RTOL, atol=RMI_ATOL
        )
    one = bank.refit_cluster(tl, _t(rows[4]), _t(valid[4]), n_leaves=5)
    np.testing.assert_array_equal(one[1].numpy(), tp[4].numpy())


# ---------------------------------------------------------------------------
# flat search
# ---------------------------------------------------------------------------


def test_flat_search_matches_jax():
    rng = np.random.default_rng(9)
    x = _unit(rng, 3000, 32)
    q = _unit(rng, 20, 32)
    jo = jflat(jnp.asarray(x), jnp.asarray(q), k=15, chunk=1024)
    to = flat_search(_t(x), _t(q), k=15, chunk=1024)
    assert_topk_match(to.ids, to.scores, _np(jo.ids), _np(jo.scores))
