"""The port's quantized device-tier search against the JAX package.

An int8 and an int4 index built and saved by the JAX package
(``build_lider`` + ``save_index``) are loaded with the port's
``load_index``. Tolerances:

- the first pass (the provisional top-k' rows of ``_verify_bank_rows``'
  first stage, against JAX's ``provisional_rows``): ids and scores
  bit-exact, with and without the sketch pre-filter;
- end to end, after the exact float32 rescore: ids equal, scores to rtol
  1e-5 / atol 1e-6 (float32 sums taken in another order);
- the port's own build, given JAX's projections and centroids: codes,
  scales, sketches, ``sorted_keys`` and ``sorted_pos`` equal.

The JAX side runs on the CPU through its plain versions, as its own tests
run the search there.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jbank
from repro.core import lider as jlider
from repro.data import synthetic as jsyn
from repro.training import checkpoint as jckpt
from repro_torch.core import bank, lider
from repro_torch.core.lsh import LSHParams
from repro_torch.testing import SCORE_ATOL, SCORE_RTOL
from repro_torch.training import checkpoint

N, D, K, P = 2000, 32, 10, 4
CFG = dict(n_clusters=16, n_probe=P, kmeans_iters=10)


@pytest.fixture(scope="module", params=["int8", "int4"])
def qindex(request, tmp_path_factory):
    """(storage, queries, JAX index, port index, save directory)."""
    sd = request.param
    x = np.array(jsyn.retrieval_corpus(0, N, D))
    q = np.array(jsyn.retrieval_queries(1, jnp.asarray(x), 48)[0])
    jp = jlider.build_lider(jax.random.PRNGKey(0), jnp.asarray(x), jlider.LiderConfig(**CFG, storage_dtype=sd))
    d = str(tmp_path_factory.mktemp(f"jax_{sd}_index"))
    jckpt.save_index(d, jp)
    return sd, q, jp, checkpoint.load_index(d, device="cpu"), d


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_loaded_quantized_index_has_the_saved_leaves(qindex):
    sd, _, jp, tp, _ = qindex
    b, jb = tp.bank, jp.bank
    assert b.quantized and b.code_dtype == sd and b.storage_dtype == sd
    assert tp.dim == D and b.embs.shape[-1] == (D // 2 if sd == "int4" else D)
    np.testing.assert_array_equal(b.embs.numpy(), np.asarray(jb.embs))
    np.testing.assert_array_equal(b.emb_scales.numpy(), np.asarray(jb.emb_scales))
    np.testing.assert_array_equal(b.rescore_embs.numpy(), np.asarray(jb.rescore_embs))
    assert b.sketches.dtype == torch.int32  # 32-bit words, not widened
    np.testing.assert_array_equal(_u32(b.sketches), np.asarray(jb.sketches))
    np.testing.assert_array_equal(b.float_rows().numpy(), np.asarray(jb.float_rows()))


@pytest.mark.parametrize("sketch_factor", [None, 4], ids=["codes", "sketch4"])
def test_first_pass_bit_exact(qindex, sketch_factor):
    """The provisional top-k' (flat rows + code-domain scores) on the same
    routed clusters equals JAX's ``provisional_rows``, bit for bit."""
    _, q, jp, tp, _ = qindex
    cids = np.array(jlider.route_queries(jp, jnp.asarray(q), n_probe=P).ids)
    jo = jlider.provisional_rows(jp, jnp.asarray(q), jnp.asarray(cids), k=K, sketch_factor=sketch_factor)
    qt, ct = torch.from_numpy(q), torch.from_numpy(cids)
    flat, gids = lider._bank_candidates(tp.bank, qt, ct, k=K, r0=4, refine=False)
    b = q.shape[0]
    out_rows = torch.where(gids >= 0, flat, -1).reshape(b, -1)
    rows, sc = lider._provisional_topk(
        tp.bank, flat.reshape(b, -1), out_rows, qt, kp=4 * K, sketch_factor=sketch_factor
    )
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jo.ids))
    np.testing.assert_array_equal(sc.numpy().view(np.uint32), np.asarray(jo.scores).view(np.uint32))


SEARCHES = {
    "plain": {},
    "sketch4": {"sketch_factor": 4},
    "sketch_covering": {"sketch_factor": 10_000},
    "block_q4": {"block_q": 4},
    "block_q4_sketch4": {"block_q": 4, "sketch_factor": 4},
    "block_q4_pruned": {"block_q": 4, "prune_margin": 0.05},
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_search_matches_jax(qindex, name):
    _, q, jp, tp, _ = qindex
    kw = dict(k=K, n_probe=P, r0=4, with_stats=True, **SEARCHES[name])
    jo, jpr = jlider.search_lider(jp, jnp.asarray(q), **kw)
    to, tpr = lider.search_lider(tp, q, **kw)
    np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
    np.testing.assert_allclose(to.scores.numpy(), np.asarray(jo.scores), rtol=SCORE_RTOL, atol=SCORE_ATOL)
    np.testing.assert_array_equal(tpr.numpy(), np.asarray(jpr))
    if name == "block_q4_pruned":
        assert tpr.any()


def test_spellings_are_bit_identical_in_the_port(qindex):
    """Cluster-major equals per-query; a covering sketch factor equals no
    pre-filter; both ids and scores, bit for bit."""
    _, q, _, tp, _ = qindex
    base = lider.search_lider(tp, q, k=K, n_probe=P)
    for kw in ({"block_q": 1}, {"block_q": 8}, {"sketch_factor": 10_000},
               {"sketch_factor": 10_000, "block_q": 4}):
        got = lider.search_lider(tp, q, k=K, n_probe=P, **kw)
        assert torch.equal(got.ids, base.ids), kw
        assert torch.equal(got.scores, base.scores), kw
    sk = lider.search_lider(tp, q, k=K, n_probe=P, sketch_factor=2)
    sk_cm = lider.search_lider(tp, q, k=K, n_probe=P, sketch_factor=2, block_q=8)
    assert torch.equal(sk.ids, sk_cm.ids) and torch.equal(sk.scores, sk_cm.scores)


def test_schedule_stats_and_fixed_padding_match_jax(qindex):
    _, q, jp, tp, _ = qindex
    jstats, tstats = {}, {}
    jprov, _ = jlider.host_first_pass_cluster_major(
        jp, jnp.asarray(q), k=K, n_probe=P, block_q=4, stats_out=jstats
    )
    tprov, _ = lider.host_first_pass_cluster_major(
        tp, torch.from_numpy(q), k=K, n_probe=P, block_q=4, stats_out=tstats
    )
    assert (tstats["n_pairs"], tstats["n_steps"]) == (jstats["n_pairs"], jstats["n_steps"])
    np.testing.assert_array_equal(tstats["cluster_counts"], jstats["cluster_counts"])
    np.testing.assert_array_equal(tprov.ids.numpy(), np.asarray(jprov.ids))
    np.testing.assert_array_equal(tprov.scores.numpy(), np.asarray(jprov.scores))


def test_per_pair_shape_matches_jax(qindex):
    _, q, jp, tp, _ = qindex
    cids = np.array(jlider.route_queries(jp, jnp.asarray(q), n_probe=P).ids)
    per_pair = jax.jit(lambda p, qq, cc: jlider.incluster_search(p, qq, cc, k=K, merge=False))
    jo = per_pair(jp, jnp.asarray(q), jnp.asarray(cids))
    to = lider.incluster_search(tp, torch.from_numpy(q), torch.from_numpy(cids), k=K, merge=False)
    assert to.ids.shape == (q.shape[0], P, K)
    np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
    np.testing.assert_allclose(to.scores.numpy(), np.asarray(jo.scores), rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_checkpoint_without_sketches_recomputes_them(qindex, tmp_path):
    """An index saved before the sketch tier has no ``bank__sketches``: the
    loader recomputes them from the rescore table, byte for byte."""
    _, _, jp, tp, d = qindex
    dst = tmp_path / "index"
    shutil.copytree(os.path.join(d, "index"), dst)
    os.remove(dst / "bank__sketches.npy")
    meta = json.loads((dst / "index_meta.json").read_text())
    del meta["leaves"]["bank__sketches"]
    (dst / "index_meta.json").write_text(json.dumps(meta))
    got = checkpoint.load_index(str(tmp_path), device="cpu")
    assert got.bank.sketches.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got.bank.sketches), np.asarray(jp.bank.sketches))
    assert torch.equal(got.bank.sketches, tp.bank.sketches)


@pytest.mark.parametrize("storage_dtype", ["int8", "int4"])
def test_port_build_bank_matches_jax(storage_dtype, monkeypatch):
    """The port's ``build_bank`` on JAX's cluster assignment, with JAX's
    LSH projections injected: stored codes, scales, rescore rows, sketches
    and the fit over the dequantized rows (``sorted_keys``, ``sorted_pos``)
    equal JAX's."""
    rng = np.random.default_rng(3)
    x = np.array(jsyn.retrieval_corpus(2, 1200, D))
    assign = rng.integers(0, 10, 1200).astype(np.int32)
    kw = dict(n_clusters=10, capacity=160, n_arrays=6, key_len=11, n_leaves=5, storage_dtype=storage_dtype)
    jb, _ = jbank.build_bank(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(assign), **kw)
    proj = torch.from_numpy(np.array(jb.lsh.projections))
    monkeypatch.setattr(
        bank.lsh_lib, "make_lsh",
        lambda g, dim, h, m: LSHParams(projections=proj, n_arrays=h, key_len=m),
    )
    monkeypatch.setattr(bank, "_FIT_CHUNK", 3)  # 10 clusters over 4 chunks
    tb, n_dropped = bank.build_bank(
        torch.Generator().manual_seed(0), torch.from_numpy(x), torch.from_numpy(assign), **kw
    )
    assert n_dropped == 0 and tb.code_dtype == storage_dtype and tb.dim == D
    np.testing.assert_array_equal(tb.embs.numpy(), np.asarray(jb.embs))
    np.testing.assert_array_equal(tb.emb_scales.numpy().view(np.uint32), np.asarray(jb.emb_scales).view(np.uint32))
    np.testing.assert_array_equal(tb.rescore_embs.numpy(), np.asarray(jb.rescore_embs))
    np.testing.assert_array_equal(_u32(tb.sketches), np.asarray(jb.sketches))
    np.testing.assert_array_equal(tb.sorted_keys.numpy(), np.asarray(jb.sorted_keys).astype(np.int64))
    np.testing.assert_array_equal(tb.sorted_pos.numpy(), np.asarray(jb.sorted_pos))
    np.testing.assert_array_equal(tb.gids.numpy(), np.asarray(jb.gids))


@pytest.mark.parametrize("storage_dtype,tier", [
    ("float32", "device"), ("int8", "device"), ("int8", "host"), ("int4", "device"), ("int4", "host"),
])
def test_chunked_build_matches_jax(storage_dtype, tier, tmp_path, monkeypatch):
    """The build's pack by chunks of clusters (``bank.pack_bank``, chunks of
    ``_PACK_ROWS`` slots that do not divide c) and the host tier's table
    filled chunk by chunk, from a torch tensor, against the JAX package's
    build from the same centroids and LSH projections: every leaf bit for
    bit but the RMI fits, which sum in another order (within
    ``tests/test_torch_core.py``'s RMI tolerance); and against the port's
    pack in one chunk from an array, every leaf bit for bit. On the CPU the
    corpus and the index share one device, so the pack's crossings of host
    memory (the host gather and the pinned write-back) do not run here:
    ``tests/test_torch_host_corpus.py`` holds them on the card."""
    x = np.array(jsyn.retrieval_corpus(6, 1500, D))
    cen = x[::150][:10]
    kw = dict(n_clusters=10, n_probe=3, n_arrays=6, key_len=11, n_arrays_centroid=4,
              key_len_centroid=5, n_leaves=5, n_leaves_centroid=4, storage_dtype=storage_dtype)
    jp = jlider.build_lider(jax.random.PRNGKey(2), jnp.asarray(x), jlider.LiderConfig(**kw),
                            centroids=jnp.asarray(cen))
    jckpt.save_index(str(tmp_path), jp)
    want = dict(checkpoint.index_leaves(checkpoint.load_index(str(tmp_path), device="cpu")))
    proj = {(6, 11): jp.bank.lsh.projections, (4, 5): jp.centroid_cm.lsh.projections}
    monkeypatch.setattr(
        bank.lsh_lib, "make_lsh",
        lambda g, dim, h, m: LSHParams(projections=torch.from_numpy(np.array(proj[h, m])),
                                       n_arrays=h, key_len=m),
    )
    lp = jp.bank.capacity
    cfg = lider.LiderConfig(**kw, rescore_tier=tier)
    monkeypatch.setattr(bank, "_PACK_ROWS", 10 * lp)
    whole = dict(checkpoint.index_leaves(lider.build_lider(0, x, cfg, centroids=cen, device="cpu")))
    monkeypatch.setattr(bank, "_PACK_ROWS", 3 * lp + lp // 2)
    assert [e - s for s, e in bank.pack_chunks(10, lp)] == [3, 3, 3, 1]
    tp = lider.build_lider(0, torch.from_numpy(x), cfg, centroids=cen, device="cpu")
    assert tp.bank.rescore_tier == tier and tp.bank.capacity == lp
    got = dict(checkpoint.index_leaves(tp))
    assert sorted(got) == sorted(want) == sorted(whole)
    bits = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    same = lambda a, b: a.dtype == b.dtype and torch.equal(bits(a), bits(b))
    assert [n for n in want if not same(got[n], whole[n])] == []
    fits = [n for n in want if "__rmi__" in n]
    assert [n for n in want if n not in fits and not same(got[n], want[n])] == []
    for n in fits:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-4, atol=1e-3, err_msg=n)


def test_quantized_core_model_search_matches_jax():
    """``search_core_model`` on an int8 table with an exact rescore, the
    standalone-model spelling of the quantized search."""
    from repro.core import core_model as jcm
    from repro.kernels import quant as jquant
    from repro_torch.core import core_model

    x = np.array(jsyn.retrieval_corpus(4, 1500, D))
    q = np.array(jsyn.retrieval_queries(5, jnp.asarray(x), 24)[0])
    jm = jcm.build_core_model(jax.random.PRNGKey(0), jnp.asarray(x), n_arrays=6, key_len=11, n_leaves=8)
    tm = core_model.fit_core_model(
        LSHParams(projections=torch.from_numpy(np.array(jm.lsh.projections)), n_arrays=6, key_len=11),
        torch.from_numpy(x), n_leaves=8,
    )
    codes, scales = jquant.quantize_rows(jnp.asarray(x))
    jo = jcm.search_core_model(
        jm, codes, jnp.asarray(q), k=K, scales=scales, rescore_embs=jnp.asarray(x), rescore_factor=3
    )
    to = core_model.search_core_model(
        tm, torch.from_numpy(np.array(codes)), torch.from_numpy(q), k=K,
        scales=torch.from_numpy(np.array(scales)), rescore_embs=torch.from_numpy(x), rescore_factor=3,
    )
    np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
    np.testing.assert_allclose(to.scores.numpy(), np.asarray(jo.scores), rtol=SCORE_RTOL, atol=SCORE_ATOL)
    with pytest.raises(ValueError, match="rescore_embs"):
        core_model.search_core_model(tm, torch.from_numpy(np.array(codes)), torch.from_numpy(q), k=K,
                                     scales=torch.from_numpy(np.array(scales)))


def test_quantized_config_operating_points():
    from repro_torch.configs import lider_msmarco

    pts = {p.name: p for p in lider_msmarco.QUANTIZED}
    assert set(pts) == {"Q8", "Q8-cm", "Q4-sk", "Q4-sk-cm"}
    assert pts["Q8"].search_kwargs() == {"rescore_factor": 4, "sketch_factor": None, "block_q": None}
    assert pts["Q4-sk-cm"].storage_dtype == "int4"
    assert pts["Q4-sk-cm"].search_kwargs() == {"rescore_factor": 4, "sketch_factor": 4, "block_q": 8}
    assert jlider.LiderConfig().rescore_factor == lider.LiderConfig().rescore_factor == 4
    assert dataclasses.replace(lider_msmarco.CONFIG.lider, storage_dtype="int8").storage_dtype == "int8"
