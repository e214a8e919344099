"""The port's LIDER index end to end against the JAX package.

An index built and saved by the JAX package (``build_lider`` +
``save_index``) is loaded with the port's ``load_index``; the port's search
must return the JAX search's ids (up to swaps of near-equal scores, see
``repro_torch.testing``) for both ``incluster_search`` shapes. The port's
own build on the same corpus must reach the JAX build's recall@10 within
0.03 (the two draw different random projections and k-means seeds).
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

from repro.configs import lider_msmarco as jcfg
from repro.core import lider as jlider
from repro.core.baselines import flat_search as jflat
from repro.core.utils import recall_at_k as jrecall
from repro.data import synthetic as jsyn
from repro.training import checkpoint as jckpt
from repro_torch.configs import lider_msmarco
from repro_torch.core import lider
from repro_torch.core.baselines import flat_search
from repro_torch.core.utils import recall_at_k
from repro_torch.data import synthetic
from repro_torch.serving import make_backend
from repro_torch.testing import assert_topk_match
from repro_torch.training import checkpoint

N, D, K = 2000, 32, 10
CFG = dict(n_clusters=16, n_probe=4, kmeans_iters=10)


@pytest.fixture(scope="module")
def jax_index(tmp_path_factory):
    """(corpus, queries, JAX index, save directory) — built once."""
    x = np.array(jsyn.retrieval_corpus(0, N, D))
    q = np.array(jsyn.retrieval_queries(1, jnp.asarray(x), 64)[0])
    jp = jlider.build_lider(jax.random.PRNGKey(0), jnp.asarray(x), jlider.LiderConfig(**CFG))
    d = str(tmp_path_factory.mktemp("jax_index"))
    jckpt.save_index(d, jp)
    return x, q, jp, d


@pytest.fixture(scope="module")
def port_index(jax_index):
    return checkpoint.load_index(jax_index[3], device="cpu")


def test_loaded_index_has_the_saved_leaves(jax_index, port_index):
    _, _, jp, _ = jax_index
    tp = port_index
    np.testing.assert_array_equal(tp.bank.sorted_keys.numpy(), np.asarray(jp.bank.sorted_keys).astype(np.int64))
    np.testing.assert_array_equal(tp.bank.embs.numpy(), np.asarray(jp.bank.embs))
    np.testing.assert_array_equal(tp.centroid_cm.sorted_ids.numpy(), np.asarray(jp.centroid_cm.sorted_ids))
    assert tp.bank.sorted_keys.dtype == torch.int64 and tp.bank.rmi.n_leaves == jp.bank.rmi.n_leaves
    assert tp.capacity == jp.capacity and tp.n_clusters == 16 and tp.dim == D
    assert tp.bank.storage_dtype == "float32" and tp.bank.rescore_tier == "device"


@pytest.mark.parametrize("n_probe,r0", [(4, 4), (2, 8)])
def test_search_on_jax_index_matches_jax(jax_index, port_index, n_probe, r0):
    _, q, jp, _ = jax_index
    jo = jlider.search_lider(jp, jnp.asarray(q), k=K, n_probe=n_probe, r0=r0)
    to = lider.search_lider(port_index, q, k=K, n_probe=n_probe, r0=r0)
    assert_topk_match(to.ids, to.scores, np.asarray(jo.ids), np.asarray(jo.scores))


def test_routing_and_per_pair_search_match_jax(jax_index, port_index):
    """Layer 1 alone, then layer 2 with ``merge=False`` ((B, P, k) per
    query-probe pair) on the same routed clusters."""
    _, q, jp, _ = jax_index
    jr = jlider.route_queries(jp, jnp.asarray(q), n_probe=4)
    tr = lider.route_queries(port_index, torch.from_numpy(q), n_probe=4)
    assert_topk_match(tr.ids, tr.scores, np.asarray(jr.ids), np.asarray(jr.scores))
    cids = np.array(jr.ids)
    per_pair = jax.jit(lambda p, qq, cc: jlider.incluster_search(p, qq, cc, k=K, merge=False))
    jo = per_pair(jp, jnp.asarray(q), jnp.asarray(cids))
    to = lider.incluster_search(port_index, torch.from_numpy(q), torch.from_numpy(cids), k=K, merge=False)
    assert to.ids.shape == (64, 4, K)
    assert_topk_match(to.ids, to.scores, np.asarray(jo.ids), np.asarray(jo.scores))


def test_refine_and_pruned_search_match_jax(jax_index, port_index):
    _, q, jp, _ = jax_index
    jo = jlider.search_lider(jp, jnp.asarray(q), k=K, n_probe=4, refine=True)
    to = lider.search_lider(port_index, q, k=K, n_probe=4, refine=True)
    assert_topk_match(to.ids, to.scores, np.asarray(jo.ids), np.asarray(jo.scores))
    jo, jpruned = jlider.search_lider(jp, jnp.asarray(q), k=K, n_probe=4, prune_margin=0.05, with_stats=True)
    to, tpruned = lider.search_lider(port_index, q, k=K, n_probe=4, prune_margin=0.05, with_stats=True)
    np.testing.assert_array_equal(tpruned.numpy(), np.asarray(jpruned))
    assert_topk_match(to.ids, to.scores, np.asarray(jo.ids), np.asarray(jo.scores))


def test_port_build_recall_close_to_jax_build(jax_index):
    x, q, jp, _ = jax_index
    gt = np.array(jflat(jnp.asarray(x), jnp.asarray(q), k=K).ids)
    j_rec = float(jrecall(jlider.search_lider(jp, jnp.asarray(q), k=K, n_probe=4).ids, jnp.asarray(gt)))
    tp, stats = lider.build_lider(0, x, lider.LiderConfig(**CFG), device="cpu", return_stats=True)
    t_rec = float(recall_at_k(lider.search_lider(tp, q, k=K, n_probe=4).ids, torch.from_numpy(gt)))
    assert stats.n_dropped == 0 and stats.n_indexed == N
    assert abs(t_rec - j_rec) <= 0.03, (t_rec, j_rec)
    assert t_rec > 0.5
    gt_port = flat_search(torch.from_numpy(x), torch.from_numpy(q), k=K).ids.numpy()
    np.testing.assert_array_equal(gt_port, gt)


def test_build_with_given_centroids_and_capacity_overflow():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    cen = x[:6]
    p = lider.build_lider(0, x, lider.LiderConfig(n_clusters=6, n_probe=2), centroids=cen, device="cpu")
    np.testing.assert_array_equal(p.centroids.numpy(), cen)
    from repro_torch.core.bank import CapacityOverflowError

    with pytest.raises(CapacityOverflowError):
        lider.build_lider(0, x, lider.LiderConfig(n_clusters=6, capacity=8), centroids=cen, device="cpu")


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((40, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lider.build_lider(0, x, lider.LiderConfig(n_clusters=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.retrieval_corpus(0, 10, 4)


def test_later_slices_raise_not_implemented(port_index, jax_index, tmp_path):
    """What the port still refuses, or treats as the JAX package does: the
    JAX package's ``use_fused`` knob, which the port has no counterpart for
    (the baselines, once refused with ``NotImplementedError``, are ported);
    the host rescore tier on a float bank raises ``ValueError`` (build and
    load), as in JAX; ``block_q`` on a float bank raises ``ValueError``, as
    in JAX; ``sketch_factor`` on a float bank (no sketches) is a no-op."""
    _, q, _, _ = jax_index
    with pytest.raises(TypeError, match="use_fused"):
        make_backend("lider", port_index, use_fused=True)
    with pytest.raises(ValueError, match="int8"):
        lider.build_lider(0, np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32),
                          lider.LiderConfig(n_clusters=4, rescore_tier="host"), device="cpu")
    leaves, meta = checkpoint.read_index_dir(os.path.join(jax_index[3], "index"))
    with pytest.raises(ValueError, match="int8"):
        checkpoint.params_from_numpy(leaves, dict(meta, rescore_tier="host"), "cpu")
    with pytest.raises(ValueError, match="quantized"):
        lider.search_lider(port_index, q, k=K, n_probe=4, block_q=8)
    assert port_index.bank.sketches is None
    a = lider.search_lider(port_index, q, k=K, n_probe=4)
    b = lider.search_lider(port_index, q, k=K, n_probe=4, sketch_factor=2)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)


def test_load_index_verifies_crc_and_falls_back_to_old(jax_index, tmp_path):
    src = os.path.join(jax_index[3], "index")
    d = tmp_path / "ck"
    shutil.copytree(src, d / "index")
    leaf = d / "index" / "bank__gids.npy"
    arr = np.load(leaf)
    arr[0, 0] = arr[0, 0] + 1
    np.save(leaf, arr)
    with pytest.raises(checkpoint.CheckpointCorruptError, match="bank__gids"):
        checkpoint.load_index(str(d), device="cpu")
    shutil.copytree(src, d / "index.old")
    p = checkpoint.load_index(str(d), device="cpu")
    np.testing.assert_array_equal(p.bank.gids.numpy(), np.asarray(jax_index[2].bank.gids))
    assert (d / "index").exists() and (d / "index.old").exists()  # read-only
    meta = json.loads((d / "index" / "index_meta.json").read_text())
    meta["format"] = "other"
    (d / "index.old" / "index_meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="not a lider index"):
        checkpoint.load_index(str(d), device="cpu")


def test_bfloat16_index_loads_and_searches_like_jax(jax_index, tmp_path):
    _, q, jp32, _ = jax_index
    # The f32 index with its table stored in bfloat16: what a bfloat16 save
    # holds (the search scores in bfloat16; the fit is not under test here).
    jp = dataclasses.replace(
        jp32, bank=dataclasses.replace(jp32.bank, embs=jp32.bank.embs.astype(jnp.bfloat16))
    )
    jckpt.save_index(str(tmp_path), jp)
    tp = checkpoint.load_index(str(tmp_path), device="cpu")
    assert tp.bank.embs.dtype == torch.bfloat16
    jo = jlider.search_lider(jp, jnp.asarray(q), k=K, n_probe=4)
    to = lider.search_lider(tp, q, k=K, n_probe=4)
    assert_topk_match(to.ids, to.scores, np.asarray(jo.ids), np.asarray(jo.scores))


def test_synthetic_data_and_config_values():
    x = synthetic.retrieval_corpus(3, 500, 16, device="cpu")
    q, ids = synthetic.retrieval_queries(4, x, 20)
    assert x.shape == (500, 16) and q.shape == (20, 16) and ids.shape == (20,)
    np.testing.assert_allclose(torch.linalg.norm(x, dim=1).numpy(), 1.0, rtol=1e-5)
    assert len(set(ids.tolist())) == 20
    assert torch.equal(x, synthetic.retrieval_corpus(3, 500, 16, device="cpu"))
    ref = jcfg.ARCH.config
    port = lider_msmarco.CONFIG
    for f in ("n_clusters", "n_probe", "n_arrays", "n_arrays_centroid", "key_len",
              "key_len_centroid", "n_leaves", "n_leaves_centroid", "r0", "r0_centroid",
              "kmeans_iters", "storage_dtype", "refine", "prune_margin"):
        assert getattr(port.lider, f) == getattr(ref.lider, f), f
    assert port.dim == ref.dim and port.k == ref.k
    assert port.batch == jcfg.ARCH.shape("serve_online").dims["batch"]
    assert port.corpus_size == ref.corpus_size == 8_847_360
    assert port.lider.n_clusters == ref.lider.n_clusters and port.lider.allow_drops is False
    # The capacity is the reference's unless the card measured a larger
    # cluster: then it is None, and REDUCED names the cluster and the drops.
    assert ref.capacity == 12_288
    if port.lider.capacity is None:
        (cut,) = [r for r in lider_msmarco.REDUCED if r.startswith("capacity 12,288 -> None")]
        assert "largest cluster" in cut and "12,769" in cut and "drop 1,430" in cut
    else:
        assert port.lider.capacity == ref.capacity
