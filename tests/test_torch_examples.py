"""The port's three serving examples (``examples/quickstart_torch.py``,
``serve_retrieval_torch.py``, ``chaos_demo_torch.py``) run in process on
the CPU at a tiny size.

- quickstart: its recall@10 against Flat is within ``RECALL_TOL`` (0.05) of
  the JAX example's at the same ``--n`` / ``--dim`` / ``--queries``. The two
  packages draw their synthetic corpora from different generators, so the
  recalls are of two corpora of one distribution, not of one corpus.
- serve_retrieval: every arrival is answered on every backend, and Flat's
  recall is exact.
- chaos_demo: the rolled-back update serves the pre-update answers bit for
  bit, the retried update commits, the fetch outage degrades one batch and
  the next is full quality again.

Without ``--device cpu`` each example refuses to run where there is no card.
"""
import re
import sys
from unittest import mock

import pytest
import torch

from repro_torch.testing import load_example

RECALL_TOL = 0.05


def test_quickstart_recall_near_the_jax_example(capsys):
    args = ["--n", "3000", "--dim", "32", "--queries", "64"]
    port = load_example("quickstart_torch").main(args + ["--device", "cpu"])
    printed_port = capsys.readouterr().out
    with mock.patch.object(sys, "argv", ["quickstart.py", *args]):
        load_example("quickstart").main()
    printed_jax = capsys.readouterr().out
    pattern = r"LIDER: recall@10 vs Flat = ([0-9.]+)"
    assert float(re.search(pattern, printed_port).group(1)) == pytest.approx(port["recall"], abs=1e-4)
    ref = float(re.search(pattern, printed_jax).group(1))
    assert abs(port["recall"] - ref) <= RECALL_TOL, (port["recall"], ref)
    assert port["query_path_cache_size"] > 0


def test_serve_retrieval_answers_every_arrival():
    out = load_example("serve_retrieval_torch").main(
        ["--n", "2000", "--dim", "32", "--queries", "32", "--arrivals", "64",
         "--batch-size", "8", "--k", "10", "--device", "cpu"])
    assert set(out) == {"lider", "flat", "ivfpq", "sklsh", "mplsh"}
    assert all(r["answered"] == 64 for r in out.values())
    assert out["flat"]["recall_at_10"] == 1.0
    assert all(r["cache_hit_rate"] > 0 and r["graph_bytes"] == 0 for r in out.values())


def test_chaos_demo_gates_hold():
    out = load_example("chaos_demo_torch").main(["--n", "2000", "--device", "cpu"])
    assert out["rollback_identical"] and out["rollbacks"] == 1
    assert out["generation"] == 1  # the retried update committed
    assert out["n_degraded"] == 32 and out["fetch_failures"] == 1 and out["fetch_retries"] == 2
    assert out["recovered"] and out["faults_fired"] == 4


@pytest.mark.parametrize("name", ["quickstart_torch", "serve_retrieval_torch", "chaos_demo_torch"])
def test_examples_refuse_the_cpu_unless_asked(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it by default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example(name).main(["--n", "2000"])
