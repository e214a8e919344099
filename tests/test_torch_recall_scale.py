"""LIDER's recall as its clusters grow: the port against the JAX package.

The synthetic corpus (768-d, ~256 points a mixture mode) at 16 clusters and
two sizes: 16,384 passages (a mean cluster of 1,024, about the
1,048,576-passage cell's) and 138,240 (a mean cluster of 8,640, the
8,847,360-passage cell's, Lp 12,312 here against 12,776 there), with
``lider-msmarco``'s in-cluster settings (H 10, key_len 16, W_i 5, r0 4, 20
Lloyd steps, k 100) and 256 queries. With all 16 clusters probed, routing
is out of the way: the recall left is the in-cluster window's, R = r0 * k =
400 rows an array, which covers 39% of the smaller mean cluster and 4.6% of
the larger.

The JAX package builds from its own seed and searches through its plain
versions. The port searches the JAX package's index, loaded from its save:
a query key bit may flip where its float64 projection lies within the
float32 rounding bound of 0 (``repro_torch.testing.query_key_flips``), and
a flipped key reads another window, so on every query whose keys agree, at
1, 2 and 16 probes, the two return the same ids up to swaps of near-equal
scores (scores to rtol 1e-5 / atol 1e-6), and their recall@100 against the
exact top-100 differs by at most those swaps and the queries whose keys
flipped. The port's own build from the JAX package's centroids and LSH
projections packs the same gids, and its rows' keys differ from the JAX
package's only in bits within the rounding bound; its recall is printed
beside. ``pytest -s`` prints the recalls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lider as jlider
from repro.core import lsh as jlsh
from repro.training import checkpoint as jckpt
from repro_torch.configs.lider_msmarco import CONFIG
from repro_torch.core import bank, lider, lsh
from repro_torch.core.lsh import LSHParams
from repro_torch.data import synthetic
from repro_torch.testing import assert_topk_match, lsh_key_flips, query_key_flips, query_keys
from repro_torch.training import checkpoint

# Both plain searches gather (queries, C, d) floats at once: 8 queries at
# 16 probes are 1.6 GB.
N_QUERIES, QUERY_CHUNK = 256, 8


def _recall(ids: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, gt)]))


@pytest.mark.parametrize("n", [16_384, 138_240])
def test_recall_against_cluster_size_matches_jax(n, tmp_path, monkeypatch):
    k, lc = CONFIG.k, CONFIG.lider
    x = synthetic.retrieval_corpus(0, n, CONFIG.dim, device="cpu")
    q, _ = synthetic.retrieval_queries(1, x, N_QUERIES)
    gt = torch.topk(q @ x.T, k, dim=1).indices.numpy()
    cfg = dataclasses.replace(lc, n_clusters=16, n_probe=16)
    jfields = {f.name for f in dataclasses.fields(jlider.LiderConfig)}
    jcfg = jlider.LiderConfig(**{f: v for f, v in dataclasses.asdict(cfg).items() if f in jfields})
    jp = jlider.build_lider(jax.random.PRNGKey(0), jnp.asarray(x.numpy()), jcfg)
    jckpt.save_index(str(tmp_path), jp)
    loaded = checkpoint.load_index(str(tmp_path), device="cpu")
    proj = {(cfg.n_arrays, cfg.key_len): jp.bank.lsh.projections,
            (cfg.n_arrays_centroid, cfg.key_len_centroid): jp.centroid_cm.lsh.projections}
    monkeypatch.setattr(
        bank.lsh_lib, "make_lsh",
        lambda g, dim, h, m: LSHParams(projections=torch.from_numpy(np.array(proj[h, m])),
                                       n_arrays=h, key_len=m),
    )
    own = lider.build_lider(0, x, cfg, centroids=np.array(jp.centroids), device="cpu")
    assert own.capacity == jp.bank.capacity
    np.testing.assert_array_equal(own.bank.gids.numpy(), np.asarray(jp.bank.gids))
    valid = own.bank.gids.reshape(-1) >= 0
    rows = own.bank.embs.reshape(-1, CONFIG.dim)[valid]
    row_flips = lsh_key_flips(rows, own.bank.lsh.projections, cfg.n_arrays, cfg.key_len,
                              lsh.hash_vectors(own.bank.lsh, rows),
                              torch.from_numpy(np.asarray(jlsh.hash_vectors(jp.bank.lsh, jnp.asarray(rows.numpy()))).astype(np.int64)))
    qn = q.numpy()
    j_keys = torch.from_numpy(np.concatenate([
        np.asarray(jlsh.hash_vectors(jp.centroid_cm.lsh, jnp.asarray(qn))),
        np.asarray(jlsh.hash_vectors(jp.bank.lsh, jnp.asarray(qn)))], axis=1).astype(np.int64))
    same, flips = query_key_flips(loaded, q, query_keys(loaded, q), j_keys)
    same = same.numpy()
    chunks = range(0, N_QUERIES, QUERY_CHUNK)
    for n_probe in (1, 2, 16):
        search = lambda p, qb: lider.search_lider(p, qb, k=k, n_probe=n_probe, r0=cfg.r0)
        j = [jlider.search_lider(jp, jnp.asarray(qn[s : s + QUERY_CHUNK]), k=k, n_probe=n_probe,
                                 r0=cfg.r0, use_fused=False) for s in chunks]
        t = [search(loaded, q[s : s + QUERY_CHUNK]) for s in chunks]
        j_ids = np.concatenate([np.asarray(o.ids) for o in j])
        j_sc = np.concatenate([np.asarray(o.scores) for o in j])
        t_ids = torch.cat([o.ids for o in t]).numpy()
        t_sc = torch.cat([o.scores for o in t]).numpy()
        swaps = assert_topk_match(t_ids[same], t_sc[same], j_ids[same], j_sc[same])
        o_ids = torch.cat([search(own, q[s : s + QUERY_CHUNK]).ids for s in chunks]).numpy()
        rec_jax, rec_port = _recall(j_ids, gt), _recall(t_ids, gt)
        print(f"N={n} c=16, mean cluster {n // 16}, Lp={own.capacity}, R={cfg.r0 * k}: recall@{k} "
              f"at n_probe {n_probe}: JAX package {rec_jax:.4f}, the port on its index "
              f"{rec_port:.4f} ({swaps} near-tie swaps; {int((~same).sum())} of {N_QUERIES} "
              f"queries with a key bit flipped within the rounding bound), the port's own build "
              f"{_recall(o_ids, gt):.4f} ({row_flips['flips']} of {row_flips['bits']} row key bits "
              f"flipped within the rounding bound)")
        assert abs(rec_jax - rec_port) <= (swaps / k + int((~same).sum())) / N_QUERIES
