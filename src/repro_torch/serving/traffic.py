"""Open-loop arrival traffic for the serving front end.

The port's own copy of the JAX package's ``serving/traffic.py`` (plain
Python and NumPy), with the same names and the same seeded traces.

Real serving load is not a closed loop (submit everything, drain once):
requests arrive on their own clock, skewed toward popular queries, in
bursts, from tenants of different sizes. This module generates seeded,
replayable traces of that shape and drives an engine through them in
real time.

- Arrival times: Poisson at ``mean_rate``, or alternating normal/burst
  episodes (``pattern="burst"``) where bursts arrive ``burst_factor``x
  faster — the workload that separates an adaptive scheduler from a
  fixed-batch loop.
- Query popularity: Zipf over a finite pool (rank-``r`` weight
  ``r^-zipf_a``), the distribution that makes a result cache pay.
- Tenants: geometric skew (tenant ``i`` submits ``tenant_skew``x more
  than tenant ``i+1``), the distribution that makes fair queueing pay.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

ARRIVAL_PATTERNS = ("closed", "zipf", "burst")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: at trace time ``t`` (seconds from start),
    submit pool query ``query_idx`` on behalf of ``tenant``."""

    t: float
    query_idx: int
    tenant: str


def zipf_weights(pool_size: int, a: float) -> np.ndarray:
    """Normalized rank-frequency weights: rank r gets r^-a."""
    w = np.arange(1, pool_size + 1, dtype=np.float64) ** -a
    return w / w.sum()


def tenant_names(n_tenants: int) -> list[str]:
    return [f"tenant{i}" for i in range(n_tenants)]


def make_trace(
    *,
    seed: int,
    n_arrivals: int,
    pool_size: int,
    mean_rate: float,
    pattern: str = "zipf",
    zipf_a: float = 1.1,
    burst_factor: float = 4.0,
    episode_len: int = 64,
    n_tenants: int = 1,
    tenant_skew: float = 2.0,
) -> list[Arrival]:
    """Seeded open-loop trace of ``n_arrivals`` requests.

    ``pattern="zipf"``: constant-rate Poisson arrivals. ``"burst"``:
    alternating episodes of ``episode_len`` arrivals at ``mean_rate`` and
    at ``burst_factor * mean_rate`` (same long-run count, spikier queue).
    ``"closed"`` puts every arrival at t=0 — the legacy submit-all shape,
    kept so one driver serves all three. Query indices are Zipf-skewed in
    every pattern; popularity is what the result cache monetizes.
    """
    if pattern not in ARRIVAL_PATTERNS:
        raise ValueError(
            f"pattern {pattern!r} not in {ARRIVAL_PATTERNS}"
        )
    if mean_rate <= 0:
        raise ValueError(f"mean_rate must be > 0, got {mean_rate}")
    rng = np.random.default_rng(seed)
    qidx = rng.choice(
        pool_size, size=n_arrivals, p=zipf_weights(pool_size, zipf_a)
    )
    tnames = tenant_names(n_tenants)
    tw = tenant_skew ** -np.arange(n_tenants, dtype=np.float64)
    tidx = rng.choice(n_tenants, size=n_arrivals, p=tw / tw.sum())
    if pattern == "closed":
        times = np.zeros(n_arrivals)
    else:
        rates = np.full(n_arrivals, mean_rate)
        if pattern == "burst":
            episode = (np.arange(n_arrivals) // max(episode_len, 1)) % 2
            rates = np.where(episode == 1, mean_rate * burst_factor, rates)
        times = np.cumsum(rng.exponential(1.0 / rates))
    return [
        Arrival(t=float(times[i]), query_idx=int(qidx[i]), tenant=tnames[tidx[i]])
        for i in range(n_arrivals)
    ]


def run_open_loop(
    engine,
    trace: Sequence[Arrival],
    pool: np.ndarray,
    *,
    drain_chunk: int = 1,
) -> list[int]:
    """Replay ``trace`` against ``engine`` in real time; returns rids in
    trace order.

    The loop interleaves submission with bounded drains
    (``drain(max_dispatches=drain_chunk)``): arrivals whose time has come
    are submitted, then at most ``drain_chunk`` batches execute, then the
    clock is checked again — so a long backlog never blocks admission
    (open loop), and the scheduler sees the queue depth each arrival
    pattern actually produces. Sleeps only when idle before the next
    arrival.

    Host-tier engines overlap batch i's exact-row fetch with batch i+1's
    compressed first pass — which needs at least two batches dispatched in
    one drain call, so ``drain_chunk`` is raised to the engine's pipeline
    depth when the served params are host-tier (``drain_chunk=1`` used to
    collapse the overlap to zero under open-loop replay).
    """
    staged = getattr(engine, "_staged_host_serving", None)
    if (
        drain_chunk is not None
        and staged is not None
        and staged()
    ):
        drain_chunk = max(drain_chunk, getattr(engine, "_pipeline_depth", 2))
    t0 = time.perf_counter()
    rids: list[int] = []
    i = 0
    n = len(trace)
    while i < n or engine.pending_requests:
        now = time.perf_counter() - t0
        while i < n and trace[i].t <= now:
            a = trace[i]
            rids.append(engine.submit(pool[a.query_idx], tenant=a.tenant))
            i += 1
        if engine.pending_requests:
            engine.drain(max_dispatches=drain_chunk)
        elif i < n:
            time.sleep(min(max(trace[i].t - now, 0.0), 1e-3))
    return rids
