"""The system under test: the few entry points of ``repro_torch`` that the
harness drives, and what it reads back from them (the index it built, the
query-path graph count, the names of its hand-written kernels).

This is the only module of the benchmark that imports the program. It is
imported after the harness has fixed the allocator's settings, and finds
the package under ``src/`` of the checkout.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.core import graphs as _graphs  # noqa: E402
from repro_torch.core.core_model import TopK  # noqa: E402,F401  (what a search returns)
from repro_torch.core import lider as _lider  # noqa: E402
from repro_torch.serving.engine import QueryResult, RetrievalEngine, make_backend  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

CSRC = SRC / "repro_torch" / "kernels" / "csrc"
LIDER_FIELDS = (
    "n_clusters", "n_probe", "n_arrays", "n_arrays_centroid", "key_len", "key_len_centroid",
    "n_leaves", "n_leaves_centroid", "r0", "r0_centroid", "kmeans_iters", "capacity",
    "pad_multiple", "storage_dtype", "rescore_tier",
)


def lider_config(cfg: dict):
    return _lider.LiderConfig(**{f: cfg[f] for f in LIDER_FIELDS})


def build(corpus: torch.Tensor, cfg: dict, seed: int):
    """``build_lider`` over the corpus on its device -> ``(params, stats)``."""
    return _lider.build_lider(seed, corpus, lider_config(cfg), return_stats=True,
                              device=corpus.device)


def searcher(params, cfg: dict):
    """``q (B, d) -> TopK``: the device-tier search at the config's options."""
    def search(q):
        return _lider.search_lider(params, q, k=cfg["k"], n_probe=cfg["n_probe"], r0=cfg["r0"],
                                   r0_centroid=cfg["r0_centroid"])
    return search


def engine(params, cfg: dict, traffic: dict) -> RetrievalEngine:
    """The serving engine over ``params``, fed by the scheduler the traffic
    names."""
    backend = make_backend("lider", params, updatable=True, n_probe=cfg["n_probe"], r0=cfg["r0"])
    sched = SchedulerConfig(dynamic_batch=traffic.get("dynamic_batch", False),
                            cache_size=traffic.get("cache_size", 0))
    return RetrievalEngine(backend, batch_size=traffic["batch"], k=cfg["k"], dim=cfg["dim"],
                           params=params, scheduler=sched)


def answer_of(result):
    """An engine's answer -> ``(ids, scores)`` as numpy, or None for a
    refusal or a degraded answer."""
    if isinstance(result, QueryResult) and not result.degraded:
        return np.asarray(result.ids), np.asarray(result.scores)
    return None


def engine_counts(eng: RetrievalEngine) -> dict:
    """The engine's counts of queries answered, batches run and pad slots."""
    s = eng.stats
    return {"n_queries": s.n_queries, "n_batches": s.n_batches, "n_padded": s.n_padded}


def index_state(params) -> dict:
    """The built index as plain tensors, in the reference's names
    (``reference.lider.STATE_KEYS``)."""
    cm, b = params.centroid_cm, params.bank
    i64 = lambda t: t.to(torch.int64)
    return {
        "centroids": params.centroids,
        "c_sorted_keys": cm.sorted_keys, "c_sorted_ids": i64(cm.sorted_ids),
        "c_key_min": cm.rescale.key_min, "c_key_max": cm.rescale.key_max,
        "c_length": cm.rescale.length, "c_root_w": cm.rmi.root_w, "c_root_b": cm.rmi.root_b,
        "c_rmi_length": cm.rmi.length, "c_leaf_w": cm.rmi.leaf_w, "c_leaf_b": cm.rmi.leaf_b,
        "b_sorted_keys": b.sorted_keys, "b_sorted_pos": i64(b.sorted_pos), "b_gids": i64(b.gids),
        "b_key_min": b.rescale.key_min, "b_key_max": b.rescale.key_max,
        "b_length": b.rescale.length, "b_root_w": b.rmi.root_w, "b_root_b": b.rmi.root_b,
        "b_rmi_length": b.rmi.length, "b_leaf_w": b.rmi.leaf_w, "b_leaf_b": b.rmi.leaf_b,
    }


def query_path_cache_size() -> int:
    return _lider.query_path_cache_size()


def release_graphs() -> None:
    """Drop the query-path graphs whose tables are gone."""
    _graphs.purge()


def hand_written_kernels() -> list[str]:
    """Names of the program's ``__global__`` functions, read from its CUDA
    sources."""
    names = set()
    for src in CSRC.glob("*.cu"):
        text = re.sub(r"__launch_bounds__\s*\([^)]*\)", "", src.read_text())
        for m in re.finditer(r"__global__[^(]*?(\w+)\s*\(", text):
            names.add(m.group(1))
    return sorted(names)
