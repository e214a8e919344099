"""Admission, fairness, caching, and batch sizing for the serving engine.

The port's own copy of the JAX package's ``serving/scheduler.py`` (plain
Python and NumPy; that package's ``serving/__init__.py`` imports JAX, so
the port keeps a copy rather than importing it). Names and decisions are
the same.

This is the control layer of the async continuous-batching front end
(DESIGN.md §Serving front end). The engine owns *execution* (device
dispatch, the host-tier pipeline, degradation); the :class:`Scheduler`
owns every decision about *what enters a batch and when*:

- **Admission**: queue-cap and deadline-based shedding decided at submit
  time (subsumes the engine's old ``max_queue`` check — the engine still
  wraps the refusal in its structured :class:`~.engine.Shed` answer).
- **Per-tenant weighted-fair queues**: start-time fair queueing over a
  virtual clock; a tenant submitting 10x faster than its peers gets its
  weight's share of batch slots, not 10x.
- **Result cache**: bounded LRU keyed by the exact query bytes plus the
  ``(k, generation, rung)`` serving context, so a hit is *bit-identical*
  to recomputing and a generation bump (``apply_updates``) naturally
  invalidates every cached answer.
- **Dynamic batch sizing**: per dispatch, the smallest pre-warmed pow2
  batch size covering the queue depth, capped by SLO headroom — small
  bursts stop paying full-batch padding latency. Every size in
  :func:`batch_ladder` is run once in ``warmup``, so sizing
  decisions never meet a first-use cost on the query path.

Everything here is plain host-side Python with no device state, so it is
cheap per dispatch and testable in isolation.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Mapping, Optional

import numpy as np

DEFAULT_TENANT = "default"

# EMA smoothing for observed per-query service time (the signal behind
# deadline admission and the SLO headroom cap on batch size).
_SERVICE_EMA_ALPHA = 0.3


def batch_ladder(batch_size: int, min_batch: int = 1) -> tuple[int, ...]:
    """Pow2 batch sizes from ``min_batch`` up to (and always including)
    ``batch_size``. Each entry is run once at warmup; dispatch picks
    from this ladder so dynamic sizing never meets a first-use cost."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    min_batch = max(1, min(min_batch, batch_size))
    sizes = []
    b = min_batch
    while b < batch_size:
        sizes.append(b)
        b *= 2
    sizes.append(batch_size)
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Front-end knobs. The default config reproduces the legacy engine
    byte-for-byte: one FIFO tenant, fixed ``batch_size`` batches, no
    cache, no SLO — so existing callers and tests see identical behavior.

    ``dynamic_batch`` turns on ladder-based batch sizing. ``cache_size``
    > 0 enables the result cache. ``slo_s`` is the per-request latency
    objective: it feeds the load signal (frontier navigation in
    ``tuning.pareto.select_operating_point``), caps dynamic batch growth
    when the oldest request is short on headroom, and — with
    ``deadline_admission`` — sheds requests predicted to miss the SLO
    even if queued now. ``max_queue`` caps total queued requests
    (the engine also honors its ``DegradePolicy.max_queue``; the tighter
    bound wins). ``tenant_weights`` maps tenant name -> relative share of
    batch slots (unlisted tenants get weight 1.0).
    """

    dynamic_batch: bool = False
    min_batch: int = 1
    cache_size: int = 0
    slo_s: Optional[float] = None
    max_queue: Optional[int] = None
    deadline_admission: bool = False
    tenant_weights: Mapping[str, float] = dataclasses.field(
        default_factory=dict
    )
    # Queue depth mapped to load_signal == 1.0; defaults to 4 * batch_size.
    depth_reference: Optional[int] = None


@dataclasses.dataclass
class Request:
    """One admitted query. ``fp`` is the cache fingerprint (None when the
    cache is off); ``tenant`` picks the fair queue it waits in."""

    rid: int
    query: np.ndarray
    t_submit: float
    tenant: str = DEFAULT_TENANT
    fp: Optional[bytes] = None


class ResultCache:
    """Bounded LRU of answered queries.

    Keys are ``(query-bytes, k, generation, rung)`` — the full serving
    context — so a hit is bit-identical to re-running the search: same
    float32 bytes in, same index generation, same operating point. The
    engine clears the cache on every ``apply_updates`` (the generation in
    the key already prevents stale hits; clearing also stops a dead
    generation's entries from occupying the bound).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._map: collections.OrderedDict[tuple, tuple] = (
            collections.OrderedDict()
        )

    @staticmethod
    def fingerprint(query: np.ndarray) -> bytes:
        """Exact-bytes fingerprint of a float32 query vector. Exactness is
        deliberate: a rounded/near-duplicate fingerprint would trade away
        the bit-identical-to-fresh-search guarantee the cache is gated on."""
        return np.ascontiguousarray(query, np.float32).tobytes()

    def get(self, fp: bytes, ctx: tuple):
        key = (fp, *ctx)
        hit = self._map.get(key)
        if hit is not None:
            self._map.move_to_end(key)
        return hit

    def put(self, fp: bytes, ctx: tuple, ids, scores) -> None:
        key = (fp, *ctx)
        self._map[key] = (ids, scores)
        self._map.move_to_end(key)
        while len(self._map) > self.capacity:
            self._map.popitem(last=False)

    def clear(self) -> None:
        self._map.clear()

    def __len__(self) -> int:
        return len(self._map)


class _TenantQueue:
    __slots__ = ("queue", "weight", "vtime")

    def __init__(self, weight: float):
        self.queue: collections.deque[Request] = collections.deque()
        self.weight = weight
        self.vtime = 0.0


class Scheduler:
    """Per-tenant weighted-fair queues + admission + batch sizing.

    Fairness is start-time fair queueing over a virtual clock: each
    tenant's ``vtime`` advances by ``1/weight`` per dequeued request, and
    ``take`` always serves the lowest-vtime backlogged tenant (ties break
    by name, deterministically). A tenant going idle does not bank
    credit: on re-enqueue its vtime catches up to the global virtual
    clock, so a burst after idling competes fairly instead of starving
    everyone else. With one tenant this degenerates to the engine's old
    FIFO exactly.
    """

    def __init__(
        self,
        cfg: SchedulerConfig,
        *,
        batch_size: int,
        deadline_s: Optional[float] = None,
        max_queue: Optional[int] = None,
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        # The engine's DegradePolicy may carry its own deadline / queue cap
        # (the PR 6 spelling); the scheduler honors the tighter of the two.
        self.deadline_s = deadline_s
        caps = [c for c in (cfg.max_queue, max_queue) if c is not None]
        self.max_queue = min(caps) if caps else None
        self.ladder = (
            batch_ladder(batch_size, cfg.min_batch)
            if cfg.dynamic_batch
            else (batch_size,)
        )
        self.cache = (
            ResultCache(cfg.cache_size) if cfg.cache_size > 0 else None
        )
        self._tenants: dict[str, _TenantQueue] = {}
        self._n_queued = 0
        self._vclock = 0.0  # global virtual time = max served vtime
        # Observed per-query service seconds (EMA at full batch); None
        # until the engine reports the first completed batch.
        self._per_query_s: Optional[float] = None

    # -- admission ---------------------------------------------------------

    def fingerprint(self, query: np.ndarray) -> Optional[bytes]:
        if self.cache is None:
            return None
        return ResultCache.fingerprint(query)

    def admit(self, req: Request) -> Optional[str]:
        """Admit (enqueue) or refuse ``req``; returns the shed reason
        (``"queue_full"`` / ``"deadline"``) or None on admission."""
        if self.max_queue is not None and self._n_queued >= self.max_queue:
            return "queue_full"
        slo = self.cfg.slo_s if self.cfg.slo_s is not None else self.deadline_s
        if (
            self.cfg.deadline_admission
            and slo is not None
            and self._per_query_s is not None
            and self._n_queued * self._per_query_s > slo
        ):
            # Predicted queueing delay alone already blows the SLO: refuse
            # now (cheap, honest) instead of serving a guaranteed miss.
            return "deadline"
        t = self._tenants.get(req.tenant)
        if t is None:
            t = self._tenants[req.tenant] = _TenantQueue(
                float(self.cfg.tenant_weights.get(req.tenant, 1.0))
            )
        if not t.queue:
            # No banked credit for idle tenants: catch up to the clock.
            t.vtime = max(t.vtime, self._vclock)
        t.queue.append(req)
        self._n_queued += 1
        return None

    # -- dequeue -----------------------------------------------------------

    def take(self, n: int) -> list[Request]:
        """Pop up to ``n`` requests, weighted-fair across tenants."""
        out: list[Request] = []
        while len(out) < n and self._n_queued:
            t = min(
                (t for t in self._tenants.items() if t[1].queue),
                key=lambda kv: (kv[1].vtime, kv[0]),
            )[1]
            out.append(t.queue.popleft())
            t.vtime += 1.0 / t.weight
            self._vclock = max(self._vclock, t.vtime)
            self._n_queued -= 1
        return out

    def __len__(self) -> int:
        return self._n_queued

    def oldest_submit(self) -> Optional[float]:
        """Submit time of the oldest queued request (across tenants)."""
        heads = [t.queue[0].t_submit for t in self._tenants.values() if t.queue]
        return min(heads) if heads else None

    # -- sizing & load -----------------------------------------------------

    def observe_service(self, batch_size: int, seconds: float) -> None:
        """Engine feedback: one batch of ``batch_size`` took ``seconds``."""
        per_q = seconds / max(batch_size, 1)
        if self._per_query_s is None:
            self._per_query_s = per_q
        else:
            self._per_query_s += _SERVICE_EMA_ALPHA * (
                per_q - self._per_query_s
            )

    def pick_batch_size(self, now: Optional[float] = None) -> int:
        """Batch size for the next dispatch: smallest ladder rung covering
        the queue depth, shrunk while the predicted batch time exceeds the
        oldest request's SLO headroom (serving a small batch *now* beats
        waiting to fill — continuous batching's core trade)."""
        if not self.cfg.dynamic_batch:
            return self.batch_size
        depth = max(self._n_queued, 1)
        bs = next((b for b in self.ladder if b >= depth), self.ladder[-1])
        slo = self.cfg.slo_s
        if slo is not None and self._per_query_s is not None:
            oldest = self.oldest_submit()
            if oldest is not None:
                if now is None:
                    now = time.perf_counter()
                headroom = slo - (now - oldest)
                i = self.ladder.index(bs)
                while i > 0 and self.ladder[i] * self._per_query_s > headroom:
                    i -= 1
                bs = self.ladder[i]
        return bs

    def load_signal(self, now: Optional[float] = None) -> float:
        """Queue pressure in [0, 1] — the control-plane input to
        ``tuning.pareto.select_operating_point``. Max of (a) depth against
        ``depth_reference`` and (b) oldest-request age against the SLO."""
        ref = self.cfg.depth_reference or 4 * self.batch_size
        sig = self._n_queued / max(ref, 1)
        slo = self.cfg.slo_s if self.cfg.slo_s is not None else self.deadline_s
        if slo is not None:
            oldest = self.oldest_submit()
            if oldest is not None:
                if now is None:
                    now = time.perf_counter()
                sig = max(sig, (now - oldest) / slo)
        return min(sig, 1.0)
