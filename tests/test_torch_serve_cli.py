"""The port's serve entry point (``repro_torch.launch.serve``), run in the
test's process through ``main([...])`` at a tiny size on the CPU.

- Every backend answers every query, with recall@10 against Flat above the
  garbage floor (Flat: exactly 1.0).
- LIDER through the router: two replicas, a rolling 20% upsert, the
  autotuned operating point and an int8 index on the host tier; open-loop
  Zipf traffic; ``--stats-json``.
- Checkpoints: the CLI's ``--save-index`` read back by ``--load-index``
  (recall unchanged) and by the JAX package's ``load_index`` (the same ids
  as the port's search, exactly); and a JAX-saved index served by the CLI:
  its recall equals that of JAX's own ``search_lider`` on the same queries
  and index, exactly (the port's answers are JAX's ids).
- No fall-back: without ``--device cpu`` and without a card the CLI raises;
  the JAX flags the port leaves out (``--use-fused``, ``--block-c``) are
  refused, as are the flag combinations the JAX CLI refuses.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import lider
from repro_torch.core.baselines import flat_search
from repro_torch.core.utils import recall_at_k
from repro_torch.data import synthetic
from repro_torch.launch import serve
from repro_torch.training import checkpoint

TINY = ["--device", "cpu", "--corpus-size", "1500", "--dim", "16", "--queries", "48",
        "--batch-size", "16", "--k", "10", "--n-clusters", "12", "--n-probe", "4"]
# Recall@10 floors: garbage only (random would be ~0.007), Flat exact.
FLOOR = {"lider": 0.5, "flat": 1.0, "pq": 0.1, "ivfpq": 0.1, "sklsh": 0.1, "mplsh": 0.1}


@pytest.mark.parametrize("backend", sorted(FLOOR))
def test_every_backend_answers(backend):
    rec = serve.main(TINY + ["--backend", backend])
    assert rec["n_answered"] == rec["n_queries"] == 48
    assert rec["recall_at_k"] >= FLOOR[backend]
    if backend == "flat":
        assert rec["recall_at_k"] == 1.0
    assert rec["router"] is None and rec["device"] == "cpu"


def test_lider_router_rolling_update_autotuned(tmp_path):
    stats = tmp_path / "stats.json"
    rec = serve.main(TINY + [
        "--storage-dtype", "int8", "--rescore-tier", "host", "--replicas", "2",
        "--rolling-update", "--update-fraction", "0.2", "--recall-target", "0.7",
        "--stats-json", str(stats),
    ])
    router = rec["router"]
    assert rec["n_answered"] == 48 and rec["recall_at_k"] >= FLOOR["lider"]
    assert router["availability"] == 1.0 and router["n_shed"] == 0
    assert router["n_roll_replicas_updated"] == 2 and router["n_rolls_completed"] == 1
    assert router["generation_window"] == [1, 1] and router["n_wrong_generation"] == 0
    assert rec["rescore_tier"] == "host" and rec["tier_bytes"]["host"] > 0
    assert rec["selected"] is not None and rec["n_host_fetches"] > 0
    assert json.loads(stats.read_text())["router"]["n_roll_replicas_updated"] == 2


def test_lider_open_loop_sketch_cluster_major():
    rec = serve.main(TINY + ["--storage-dtype", "int4", "--sketch-factor", "4", "--block-q", "8",
                             "--arrival", "zipf", "--tenants", "2", "--dynamic-batch"])
    assert rec["n_answered"] == 48 and rec["recall_at_k"] >= FLOOR["lider"]
    assert rec["storage_dtype"] == "int4" and rec["arrival"] == "zipf"


def test_save_load_round_trip_and_jax_reads_it(tmp_path):
    import jax.numpy as jnp
    from repro.core import lider as jlider
    from repro.training import checkpoint as jckpt

    d = str(tmp_path / "idx")
    first = serve.main(TINY + ["--storage-dtype", "int8", "--save-index", d])
    again = serve.main(TINY + ["--load-index", d])
    assert again["recall_at_k"] == first["recall_at_k"] and again["storage_dtype"] == "int8"
    # The JAX package loads the CLI's save and answers as the port does.
    x = synthetic.retrieval_corpus(0, 1500, 16, device="cpu")
    q, _ = synthetic.retrieval_queries(1, x, 48)
    want = lider.search_lider(checkpoint.load_index(d, device="cpu"), q, k=10, n_probe=4)
    got = jlider.search_lider(jckpt.load_index(d), jnp.asarray(q.numpy()), k=10, n_probe=4)
    np.testing.assert_array_equal(np.asarray(got.ids), want.ids.numpy())


def test_serves_a_jax_saved_index(tmp_path):
    """A JAX-built host-tier int8 index over the corpus the CLI makes: the
    CLI's recall equals JAX's own search of the same queries, exactly."""
    import jax
    import jax.numpy as jnp
    from repro.core import lider as jlider
    from repro.training import checkpoint as jckpt

    x = synthetic.retrieval_corpus(0, 1500, 16, device="cpu")
    q, _ = synthetic.retrieval_queries(1, x, 48)
    cfg = jlider.LiderConfig(n_clusters=12, n_probe=4, storage_dtype="int8", rescore_tier="host")
    jp = jlider.build_lider(jax.random.PRNGKey(0), jnp.asarray(x.numpy()), cfg)
    d = str(tmp_path / "jax_idx")
    jckpt.save_index(d, jp)
    rec = serve.main(TINY + ["--load-index", d])
    assert rec["rescore_tier"] == "host" and rec["storage_dtype"] == "int8"
    jids = torch.from_numpy(np.array(
        jlider.search_lider(jp, jnp.asarray(q.numpy()), k=10, n_probe=4).ids))
    assert rec["recall_at_k"] == float(recall_at_k(jids, flat_search(x, q, k=10).ids))


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(args + ["--backend", "flat"])


@pytest.mark.parametrize("bad", [
    ["--use-fused", "on"],
    ["--block-c", "256"],
    ["--backend", "pq", "--update-fraction", "0.1"],
    ["--backend", "flat", "--recall-target", "0.9"],
    ["--rolling-update", "--replicas", "1", "--update-fraction", "0.1"],
    ["--rescore-tier", "host"],
    ["--block-q", "8"],
    ["--replicas", "0"],
])
def test_refused_flags(bad):
    with pytest.raises(SystemExit):
        serve.parse_args(TINY + bad)
