"""The benchmark's own inputs, made from the seed: a clustered unit-norm
corpus, queries near corpus points, and open-loop arrival traces.

Frozen copies of the program's seeded generators, kept here so that a
change to the program cannot move the yardstick:

- :func:`retrieval_corpus` and :func:`retrieval_queries` are
  ``repro_torch/data/synthetic.py``'s, drawn with a seeded
  ``torch.Generator`` on the target device, in a few large calls;
- :func:`make_trace` is ``repro_torch/serving/traffic.py``'s (Poisson or
  bursty arrivals, Zipf popularity over a pool, skewed tenants), returning
  arrays instead of a list of records.
"""
from __future__ import annotations

import numpy as np
import torch

ARRIVAL_PATTERNS = ("zipf", "burst")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def retrieval_corpus(
    seed: int, n: int, dim: int, *, n_modes: int | None = None, spread: float = 0.35,
    device: torch.device,
) -> torch.Tensor:
    """Clustered unit-norm corpus (N, d) float32, ~256 points a mixture mode."""
    n_modes = n_modes or max(16, n // 256)
    g = torch.Generator(device=device).manual_seed(seed)
    modes = torch.randn((n_modes, dim), generator=g, device=device)
    assign = torch.randint(0, n_modes, (n,), generator=g, device=device)
    pts = modes[assign]
    del modes, assign
    pts.add_(torch.randn((n, dim), generator=g, device=device), alpha=spread)
    return l2_normalize(pts)


def retrieval_queries(
    seed: int, corpus: torch.Tensor, n_queries: int, *, noise: float = 0.08
) -> torch.Tensor:
    """(Q, d) unit-norm queries: distinct corpus points plus Gaussian noise,
    on the corpus's device."""
    device = corpus.device
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    ids = torch.randperm(corpus.shape[0], generator=g, device=device)[:n_queries]
    q = corpus[ids] + noise * torch.randn((ids.shape[0], corpus.shape[1]), generator=g, device=device)
    return l2_normalize(q)


def zipf_weights(pool_size: int, a: float) -> np.ndarray:
    w = np.arange(1, pool_size + 1, dtype=np.float64) ** -a
    return w / w.sum()


def make_trace(
    *, seed: int, n_arrivals: int, pool_size: int, mean_rate: float, pattern: str = "zipf",
    zipf_a: float = 1.1, burst_factor: float = 4.0, episode_len: int = 64,
    n_tenants: int = 1, tenant_skew: float = 2.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded open-loop trace -> ``(times (n,) seconds from the start,
    pool indices (n,), tenant indices (n,))``.

    ``"zipf"``: Poisson arrivals at ``mean_rate``. ``"burst"``: alternating
    episodes of ``episode_len`` arrivals at ``mean_rate`` and at
    ``burst_factor * mean_rate``. Pool indices are Zipf-skewed in both."""
    if pattern not in ARRIVAL_PATTERNS:
        raise ValueError(f"pattern {pattern!r} not in {ARRIVAL_PATTERNS}")
    if mean_rate <= 0:
        raise ValueError(f"mean_rate must be > 0, got {mean_rate}")
    rng = np.random.default_rng(seed)
    qidx = rng.choice(pool_size, size=n_arrivals, p=zipf_weights(pool_size, zipf_a))
    tw = tenant_skew ** -np.arange(n_tenants, dtype=np.float64)
    tidx = rng.choice(n_tenants, size=n_arrivals, p=tw / tw.sum())
    rates = np.full(n_arrivals, float(mean_rate))
    if pattern == "burst":
        episode = (np.arange(n_arrivals) // max(episode_len, 1)) % 2
        rates = np.where(episode == 1, mean_rate * burst_factor, rates)
    times = np.cumsum(rng.exponential(1.0 / rates))
    return times, qidx, tidx
