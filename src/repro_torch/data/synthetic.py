"""Synthetic data: a clustered unit-norm retrieval corpus, queries that are
perturbed corpus points, and language-model token batches.

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


def step_seed(seed: int, step: int) -> int:
    """One generator seed per (seed, step) pair (numpy's ``SeedSequence``
    hash of the pair)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
