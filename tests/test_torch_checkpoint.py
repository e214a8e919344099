"""The port's ``save_index`` against the JAX package's index checkpoints.

- The port's save of a JAX-built index is byte-identical, file for file
  (every leaf, its CRC32 and the meta), to JAX's own save of it.
- JAX's ``load_index`` reads an index the port built, updated and saved,
  and its search returns the port's ids.
- The write is atomic as in ``tests/test_faults.py``: the orphan-tmp sweep,
  a ``truncate`` fault detected at load, and a ``torn_write`` crash inside
  the swap window recovered from ``index.old``. The port's ``load_index``
  reads without modifying the directory (JAX's promotes ``index.old``
  back), so after the recovery both directories are still there.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lider as jlider
from repro.data import synthetic as jsyn
from repro.training import checkpoint as jckpt
from repro_torch import faults
from repro_torch.core import lider, update
from repro_torch.testing import assert_topk_match
from repro_torch.training import checkpoint

N, D, K, P = 2000, 32, 10, 4
CFG = dict(n_clusters=16, n_probe=P, kmeans_iters=10)


@pytest.fixture(scope="module")
def corpus():
    x = np.array(jsyn.retrieval_corpus(0, N, D))
    q = np.array(jsyn.retrieval_queries(1, jnp.asarray(x), 48)[0])
    return x, q


def _files(d: str) -> dict[str, bytes]:
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8", "int4"])
def test_port_save_of_a_jax_index_is_byte_identical(corpus, storage, tmp_path):
    x, _ = corpus
    sd = "float32" if storage == "bfloat16" else storage
    jp = jlider.build_lider(jax.random.PRNGKey(0), jnp.asarray(x), jlider.LiderConfig(**CFG, storage_dtype=sd))
    if storage == "bfloat16":  # the float index with its table stored in bfloat16
        jp = dataclasses.replace(jp, bank=dataclasses.replace(jp.bank, embs=jp.bank.embs.astype(jnp.bfloat16)))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_index(jdir, jp)
    path = checkpoint.save_index(tdir, checkpoint.load_index(jdir, device="cpu"))
    assert path == os.path.join(tdir, "index")
    want, got = _files(os.path.join(jdir, "index")), _files(path)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert sorted(os.listdir(tdir)) == ["index"]  # no temporary or old directory left


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_jax_loads_and_searches_a_port_written_index(corpus, storage, tmp_path):
    """An index the port built, upserted into and deleted from, saved by
    the port: JAX's ``load_index`` reads it leaf for leaf, and JAX's search
    on it returns the port's ids."""
    x, q = corpus
    tp = lider.build_lider(0, x[:1800], lider.LiderConfig(**CFG, storage_dtype=storage), device="cpu")
    tp, _ = update.upsert(tp, x[1800:])
    tp, _ = update.delete(tp, np.arange(0, 2000, 37), refit_threshold=0.1)
    checkpoint.save_index(str(tmp_path), tp)
    jp = jckpt.load_index(str(tmp_path))
    for name, t in checkpoint.index_leaves(tp):
        arr, _ = checkpoint._leaf_array(name, t)
        j = np.asarray(jckpt._checked_load(os.path.join(str(tmp_path), "index"), name, None))
        assert j.dtype == arr.dtype and np.array_equal(j, arr), name
    assert jp.bank.storage_dtype == storage and int(jp.bank.next_gid) == N
    jo = jlider.search_lider(jp, jnp.asarray(q), k=K, n_probe=P)
    to = lider.search_lider(tp, q, k=K, n_probe=P)
    assert_topk_match(to.ids, to.scores, np.asarray(jo.ids), np.asarray(jo.scores))


def test_save_load_roundtrip_is_bit_identical(corpus, tmp_path):
    x, q = corpus
    tp = lider.build_lider(0, x, lider.LiderConfig(**CFG, storage_dtype="int4"), device="cpu")
    tp, _ = update.upsert(tp, x[:32] * 0.98)  # persist a mutated index
    checkpoint.save_index(str(tmp_path), tp)
    back = checkpoint.load_index(str(tmp_path), device="cpu")
    for (name, a), (_, b) in zip(checkpoint.index_leaves(tp), checkpoint.index_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    a = lider.search_lider(tp, q, k=K, n_probe=P)
    b = lider.search_lider(back, q, k=K, n_probe=P)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)


def test_orphan_tmp_dirs_are_swept(tmp_path, corpus):
    d = str(tmp_path)
    for name in (".tmp_ckpt_dead", ".tmp_index_dead"):
        os.makedirs(os.path.join(d, name))
        with open(os.path.join(d, name, "leaf.npy"), "wb") as f:
            f.write(b"x")
    assert checkpoint.sweep_orphan_tmp(d) == 2
    assert not any(n.startswith(".tmp") for n in os.listdir(d))
    assert checkpoint.sweep_orphan_tmp(os.path.join(d, "missing")) == 0
    # save_index sweeps on entry.
    os.makedirs(os.path.join(d, ".tmp_index_dead2"))
    x, _ = corpus
    checkpoint.save_index(d, lider.build_lider(0, x[:400], lider.LiderConfig(n_clusters=4), device="cpu"))
    assert sorted(os.listdir(d)) == ["index"]


def test_truncate_fault_is_detected_at_load(tmp_path, corpus):
    x, _ = corpus
    p = lider.build_lider(0, x[:400], lider.LiderConfig(n_clusters=4), device="cpu")
    plan = faults.FaultPlan([faults.FaultSpec("checkpoint_write", mode="truncate", times=(0,),
                                              payload={"leaf": "bank__gids"})])
    with faults.activate(plan):
        checkpoint.save_index(str(tmp_path), p)
    assert plan.n_fired == 1
    with pytest.raises(checkpoint.CheckpointCorruptError, match="bank__gids"):
        checkpoint.load_index(str(tmp_path), device="cpu")


def test_torn_index_write_recovers_from_index_old(tmp_path, corpus):
    x, q = corpus
    params = lider.build_lider(0, x, lider.LiderConfig(**CFG), device="cpu")
    d = os.path.join(str(tmp_path), "idx")
    checkpoint.save_index(d, params)
    want = lider.search_lider(params, q, k=K, n_probe=P)
    newer, _ = update.upsert(params, x[:64] * 0.97)
    plan = faults.FaultPlan([faults.FaultSpec("checkpoint_write", mode="torn_write", times=(0,))])
    with pytest.raises(faults.InjectedFault):
        with faults.activate(plan):
            checkpoint.save_index(d, newer)  # crashes inside the swap window
    assert os.path.isdir(os.path.join(d, "index.old"))
    # The torn new index fails its CRC; the load falls back to index.old.
    loaded = checkpoint.load_index(d, device="cpu")
    got = lider.search_lider(loaded, q, k=K, n_probe=P)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    assert int(loaded.bank.next_gid) == N
    assert os.path.isdir(os.path.join(d, "index.old"))  # the port's load is read-only
    # JAX's load recovers the same index and promotes index.old back.
    jp = jckpt.load_index(d)
    assert int(jp.bank.next_gid) == N and not os.path.exists(os.path.join(d, "index.old"))
    # The recovered checkpoint is healthy: a fresh save and load work.
    checkpoint.save_index(d, loaded)
    checkpoint.load_index(d, device="cpu")
    assert sorted(os.listdir(d)) == ["index"]
