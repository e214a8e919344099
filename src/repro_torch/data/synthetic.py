"""Synthetic data: a clustered unit-norm retrieval corpus, queries that are
perturbed corpus points, language-model token batches, recsys batches, a
random graph in CSR form and batches of small molecule-like graphs.

The same generators as the JAX package's ``repro.data.synthetic``, drawn
with a seeded ``torch.Generator`` on the target device (so a 1M x 768
corpus never crosses the host). The two frameworks' random streams differ:
the same seed gives different data in the two packages.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.utils import l2_normalize
from ..device import resolve_device


def load_embeddings(path: str, *, device: str | torch.device | None = None) -> torch.Tensor:
    """A ``.npy`` corpus (N, d), row-normalised, as float32 on ``device``."""
    x = torch.from_numpy(np.load(path).astype(np.float32, copy=False))
    return l2_normalize(x.to(resolve_device(device)))


def retrieval_corpus(
    seed: int,
    n: int,
    dim: int,
    *,
    n_modes: int | None = None,
    spread: float = 0.35,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Clustered unit-norm corpus (N, d), ~256 points per mixture mode."""
    device = resolve_device(device)
    n_modes = n_modes or max(16, n // 256)
    g = torch.Generator(device=device).manual_seed(seed)
    modes = torch.randn((n_modes, dim), generator=g, device=device)
    assign = torch.randint(0, n_modes, (n,), generator=g, device=device)
    pts = modes[assign]
    pts.add_(torch.randn((n, dim), generator=g, device=device), alpha=spread)
    return l2_normalize(pts)


def retrieval_queries(
    seed: int, corpus: torch.Tensor, n_queries: int, *, noise: float = 0.08
) -> tuple[torch.Tensor, torch.Tensor]:
    """Queries near known corpus points -> (queries (Q, d), seed ids (Q,)),
    on the corpus's device."""
    device = corpus.device
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    ids = torch.randperm(corpus.shape[0], generator=g, device=device)[:n_queries]
    q = corpus[ids] + noise * torch.randn(
        (n_queries, corpus.shape[1]), generator=g, device=device
    )
    return l2_normalize(q), ids


def lm_batch(
    seed: int, step: int, *, batch: int, seq: int, vocab: int,
    device: str | torch.device | None = None,
) -> dict:
    """Uniform random tokens (B, S+1) on ``device`` -> ``{"tokens",
    "targets"}`` shifted by one; a pure function of (seed, step), so a
    restarted run replays the same stream."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    tokens = torch.randint(0, vocab, (batch, seq + 1), generator=g, device=device)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


def recsys_batch(seed: int, step: int, *, kind: str, batch: int, cfg,
                 device: str | torch.device | None = None) -> dict:
    """A batch of ``cfg``'s recsys ``kind``, int32 ids (float32 labels) on
    ``device``, a pure function of (seed, step) as in the reference (which
    folds the step into ``PRNGKey(seed + 17)``)."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(step_seed(seed + 17, step))

    def ids(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device).to(torch.int32)

    def labels():
        return (torch.rand((batch,), generator=g, device=device) < 0.5).float()

    if kind == "sasrec":
        return {name: ids(1, cfg.item_vocab, (batch, cfg.seq_len)) for name in ("seq", "pos", "neg")}
    if kind == "two_tower":
        user = ids(0, cfg.field_vocab, (batch, cfg.n_user_fields))
        item = torch.cat([ids(0, cfg.item_vocab, (batch, 1)),
                          ids(0, cfg.field_vocab, (batch, cfg.n_item_fields - 1))], dim=1)
        return {"user_fields": user, "item_fields": item}
    if kind == "din":
        return {"history": ids(0, cfg.item_vocab, (batch, cfg.seq_len)),
                "target": ids(0, cfg.item_vocab, (batch,)), "label": labels()}
    if kind == "xdeepfm":
        return {"fields": ids(0, cfg.field_vocab, (batch, cfg.n_sparse)), "label": labels()}
    raise ValueError(kind)


def random_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int, n_classes: int, *,
                 device: str | torch.device | None = None) -> dict:
    """A random sparse graph on ``device``: uniform int32 edges
    ``edge_index`` (2, E), normal features, int32 labels, and the CSR by
    source the neighbour sampler reads: ``indptr`` (N+1,) and ``indices``
    (the destinations ordered by source, a stable sort)."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed + 31)
    src = torch.randint(0, n_nodes, (n_edges,), generator=g, device=device).to(torch.int32)
    dst = torch.randint(0, n_nodes, (n_edges,), generator=g, device=device).to(torch.int32)
    feat = torch.randn((n_nodes, d_feat), generator=g, device=device)
    labels = torch.randint(0, n_classes, (n_nodes,), generator=g, device=device).to(torch.int32)
    src_s, order = torch.sort(src, stable=True)
    counts = torch.bincount(src_s, minlength=n_nodes)
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
    return {
        "node_feat": feat,
        "edge_index": torch.stack([src, dst]),
        "labels": labels,
        "indptr": indptr,
        "indices": dst[order],
    }


def molecule_batch(seed: int, step: int, *, n_graphs: int, nodes_per: int, edges_per: int,
                   d_feat: int, device: str | torch.device | None = None) -> dict:
    """``n_graphs`` small random graphs as one disjoint graph (edges within
    each graph), 4 edge features, a regression target per graph."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(step_seed(seed + 47, step))
    n, e = n_graphs * nodes_per, n_graphs * edges_per
    graphs = torch.arange(n_graphs, device=device)
    base = (graphs * nodes_per).repeat_interleave(edges_per)
    src = torch.randint(0, nodes_per, (e,), generator=g, device=device) + base
    dst = torch.randint(0, nodes_per, (e,), generator=g, device=device) + base
    return {
        "node_feat": torch.randn((n, d_feat), generator=g, device=device),
        "edge_index": torch.stack([src, dst]).to(torch.int32),
        "edge_feat": torch.randn((e, 4), generator=g, device=device),
        "graph_ids": graphs.repeat_interleave(nodes_per).to(torch.int32),
        "n_graphs": n_graphs,
        "graph_targets": torch.randn((n_graphs,), generator=g, device=device),
    }


def step_seed(seed: int, step: int) -> int:
    """One generator seed per (seed, step) pair (numpy's ``SeedSequence``
    hash of the pair)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
