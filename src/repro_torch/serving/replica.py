"""Replica set + health model for the multi-replica serving fabric.

The port of the JAX package's ``serving/replica.py``, decision for
decision: the same states, thresholds and per-replica seeded backoff
jitter. One :class:`Replica` wraps one :class:`~.engine.RetrievalEngine`
(its own params, generation counter and CUDA stream); a
:class:`ReplicaSet` tracks per-replica health and picks dispatch targets
for the :class:`~.router.QueryRouter`.

Health is a four-state machine driven by two signal families — heartbeat
probes and per-batch dispatch outcomes (an EWMA of latency plus
consecutive-failure streaks):

    healthy -> suspect      first dispatch failure / missed heartbeat
    suspect -> dead         ``dead_after`` consecutive failures
    dead -> recovering      reprobe after a seeded-jitter exponential
                            backoff window
    recovering -> healthy   ``recover_successes`` consecutive successes
    recovering -> dead      failed reprobe; backoff doubles (capped)

Suspect replicas still serve (deprioritized by routing); dead replicas
take no traffic. A *killed* replica (the ``replica_kill`` fault, or an
operator action) is dead and never reprobed. A replica that misses a
rolling update while dead is marked *stale* and stays out of routing even
if it later recovers — serving it again would violate the zero
wrong-generation guarantee.

All transitions run under the set's lock: the router records outcomes
from dispatch worker threads (hedge losers complete asynchronously).
Backoff jitter is drawn from a per-replica seeded RNG, so a chaos replay
schedules the same reprobe windows regardless of thread interleaving.
"""
from __future__ import annotations

import collections
import dataclasses
import random
import threading
import time
from typing import Iterable, Optional, Sequence

from .. import faults

# Health states.
HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
RECOVERING = "recovering"

_STATE_RANK = {HEALTHY: 0, RECOVERING: 1, SUSPECT: 2, DEAD: 3}

# EWMA smoothing for per-batch dispatch latency.
_LATENCY_EWMA_ALPHA = 0.3


def clone_params(params):
    """Independent per-replica copy of served params.

    Device-tier leaves are shared: the port's updates replace a table
    rather than write into it (``core.update`` clones before it scatters),
    so sharing them is as safe as sharing JAX's immutable arrays, and
    free. A host-tier :class:`~..core.bank.EmbStore` is written IN PLACE on
    update, so each replica gets its own copy of the store's table and
    gids, or one replica's update would bleed into another's generation.
    """
    from ..core.bank import EmbStore

    bank = getattr(params, "bank", None)
    store = getattr(bank, "store", None)
    if store is None:
        return params
    new_store = EmbStore(
        store.rescore.clone(),
        gids=None if store.gids is None else store.gids.clone(),
    )
    return dataclasses.replace(params, bank=dataclasses.replace(bank, store=new_store))


class ReplicaDead(RuntimeError):
    """Dispatch hit a dead/killed replica; the router fails the batch over."""

    def __init__(self, name: str, message: str = ""):
        super().__init__(message or f"replica {name!r} is dead")
        self.replica = name


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Thresholds and backoff knobs for the replica health machine.

    ``dead_after`` counts *consecutive* failures (dispatch errors or
    heartbeat misses); a single success resets the streak. Reprobe backoff
    is ``reprobe_backoff_s * mult**k`` (capped) scaled by a deterministic
    jitter in [1, 2) from a per-replica seeded RNG. ``heartbeat_interval_s``
    paces liveness probes of serving replicas (0 disables them; dead
    replicas are always reprobed on their backoff schedule).
    """

    ewma_alpha: float = _LATENCY_EWMA_ALPHA
    dead_after: int = 3
    recover_successes: int = 2
    reprobe_backoff_s: float = 0.05
    reprobe_backoff_mult: float = 2.0
    reprobe_backoff_max_s: float = 5.0
    heartbeat_interval_s: float = 0.0
    seed: int = 0


class Replica:
    """One serving replica: an engine plus its health bookkeeping."""

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine
        self.state = HEALTHY
        self.killed = False
        self.stale = False  # missed a rolling update while dead
        self.updating = False  # masked out while apply_updates runs
        self.outstanding = 0  # dispatched batches not yet completed
        self.lock = threading.Lock()  # serializes engine execution
        self.lat_ewma: Optional[float] = None
        self.err_streak = 0
        self.ok_streak = 0
        self.reprobe_at: Optional[float] = None
        self.backoff_s: Optional[float] = None
        self.last_used = 0  # router dispatch sequence (LRU round-robin)
        self.last_heartbeat = 0.0
        self.n_dispatches = 0
        self.n_failures = 0

    @property
    def generation(self) -> int:
        return self.engine.generation

    def serveable(self) -> bool:
        """Eligible for routing (dead/killed/stale/updating are masked)."""
        return (
            not self.killed
            and not self.stale
            and not self.updating
            and self.state != DEAD
        )

    def health(self) -> dict:
        """Snapshot for stats reporting."""
        return {
            "state": self.state,
            "killed": self.killed,
            "stale": self.stale,
            "generation": self.generation,
            "lat_ewma_s": self.lat_ewma,
            "n_dispatches": self.n_dispatches,
            "n_failures": self.n_failures,
        }


class ReplicaSet:
    """Health-tracked replica collection with deterministic reprobe backoff.

    ``engines`` may be engines (auto-named ``r0..rN``) or ``(name, engine)``
    pairs. ``fault_plan`` (shared with the router and usually with every
    engine) drives the ``replica_heartbeat`` site.
    """

    def __init__(
        self,
        engines: Iterable,
        *,
        policy: HealthPolicy | None = None,
        fault_plan=None,
        lock: threading.RLock | None = None,
    ):
        self.policy = policy if policy is not None else HealthPolicy()
        self.fault_plan = fault_plan
        self.lock = lock if lock is not None else threading.RLock()
        self.replicas: list[Replica] = []
        for i, item in enumerate(engines):
            if isinstance(item, Replica):
                self.replicas.append(item)
            elif isinstance(item, tuple):
                self.replicas.append(Replica(item[0], item[1]))
            else:
                self.replicas.append(Replica(f"r{i}", item))
        if not self.replicas:
            raise ValueError("ReplicaSet needs at least one replica")
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self._rngs = {
            r.name: random.Random(f"{self.policy.seed}:{r.name}")
            for r in self.replicas
        }
        self.n_heartbeats = 0
        self.n_heartbeat_misses = 0
        self.transitions: collections.deque = collections.deque(maxlen=256)

    def __iter__(self):
        return iter(self.replicas)

    def __len__(self) -> int:
        return len(self.replicas)

    def get(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica named {name!r}")

    # -- routing -----------------------------------------------------------

    def pick(
        self,
        *,
        exclude: Sequence[str] = (),
        generation: Optional[int] = None,
        idle_only: bool = False,
    ) -> Optional[Replica]:
        """Best dispatch target, or None when no serveable replica matches.

        Preference order: fewest in-flight batches, then health rank
        (healthy < recovering < suspect), then least-recently-used — which
        degenerates to round-robin across idle healthy replicas.
        ``generation`` restricts to replicas serving that index generation
        (the hedging constraint: a hedge must be bit-safe to swap in).
        ``idle_only`` additionally requires zero in-flight batches — the
        router's hedging constraint: a hedge onto a busy replica queues
        behind its in-flight work (execution is serialized per replica)
        and loses the race by construction, so it is better not sent.
        """
        with self.lock:
            eligible = [
                r
                for r in self.replicas
                if r.serveable()
                and r.name not in exclude
                and (generation is None or r.generation == generation)
                and (not idle_only or r.outstanding == 0)
            ]
            if not eligible:
                return None
            return min(
                eligible,
                key=lambda r: (
                    r.outstanding,
                    _STATE_RANK[r.state],
                    r.last_used,
                ),
            )

    def n_serveable(self) -> int:
        with self.lock:
            return sum(r.serveable() for r in self.replicas)

    # -- outcome recording -------------------------------------------------

    def _transition(self, r: Replica, state: str) -> None:
        if r.state != state:
            self.transitions.append((r.name, r.state, state))
            r.state = state

    def record_success(self, r: Replica, latency_s: Optional[float]) -> None:
        """One successful dispatch (or heartbeat) outcome."""
        with self.lock:
            r.n_dispatches += latency_s is not None
            if latency_s is not None:
                if r.lat_ewma is None:
                    r.lat_ewma = latency_s
                else:
                    r.lat_ewma += self.policy.ewma_alpha * (
                        latency_s - r.lat_ewma
                    )
            r.err_streak = 0
            r.ok_streak += 1
            if r.state == SUSPECT:
                self._transition(r, HEALTHY)
            elif (
                r.state == RECOVERING
                and r.ok_streak >= self.policy.recover_successes
            ):
                self._transition(r, HEALTHY)
                r.backoff_s = None  # healthy again: backoff resets

    def record_failure(self, r: Replica, now: Optional[float] = None) -> None:
        """One failed dispatch/heartbeat; advances the state machine."""
        if now is None:
            now = time.perf_counter()
        with self.lock:
            r.n_failures += 1
            r.ok_streak = 0
            r.err_streak += 1
            if r.killed:
                self._transition(r, DEAD)
                r.reprobe_at = None  # killed replicas are never reprobed
                return
            if r.state == RECOVERING or r.err_streak >= self.policy.dead_after:
                # A failed reprobe goes straight back to dead with a doubled
                # window; a serving replica dies after dead_after strikes.
                self._transition(r, DEAD)
                base = self.policy.reprobe_backoff_s
                r.backoff_s = min(
                    base
                    if r.backoff_s is None
                    else r.backoff_s * self.policy.reprobe_backoff_mult,
                    self.policy.reprobe_backoff_max_s,
                )
                jitter = 1.0 + self._rngs[r.name].random()
                r.reprobe_at = now + r.backoff_s * jitter
            elif r.state == HEALTHY:
                self._transition(r, SUSPECT)

    def kill(self, name: str) -> Replica:
        """Hard-kill: dead immediately, never reprobed, in-flight batches
        fail over (the dispatch worker re-checks ``killed`` on completion)."""
        r = self.get(name)
        with self.lock:
            r.killed = True
            self._transition(r, DEAD)
            r.reprobe_at = None
        return r

    # -- heartbeats --------------------------------------------------------

    def heartbeat(self, r: Replica) -> bool:
        """Probe one replica; returns liveness. Fires ``replica_heartbeat``
        (generic ``error`` = missed heartbeat; ``miss`` targets one replica
        via payload)."""
        self.n_heartbeats += 1
        ok = True
        if self.fault_plan is not None:
            try:
                spec = self.fault_plan.fire(faults.REPLICA_HEARTBEAT)
            except faults.InjectedFault:
                ok = False
            else:
                if (
                    spec is not None
                    and spec.mode == "miss"
                    and faults.spec_targets(spec, r.name)
                ):
                    ok = False
        if r.killed:
            ok = False
        if not ok:
            self.n_heartbeat_misses += 1
        return ok

    def tick(self, now: Optional[float] = None) -> None:
        """Advance time-driven health work: reprobe dead replicas whose
        backoff window has passed, and (if configured) heartbeat serving
        replicas on the ``heartbeat_interval_s`` cadence."""
        if now is None:
            now = time.perf_counter()
        for r in self.replicas:
            if r.killed or r.updating:
                continue
            if r.state == DEAD:
                if r.reprobe_at is not None and now >= r.reprobe_at:
                    with self.lock:
                        self._transition(r, RECOVERING)
                        r.ok_streak = 0
                    if self.heartbeat(r):
                        self.record_success(r, None)
                    else:
                        self.record_failure(r, now)
            elif (
                self.policy.heartbeat_interval_s > 0
                and now - r.last_heartbeat >= self.policy.heartbeat_interval_s
            ):
                r.last_heartbeat = now
                if self.heartbeat(r):
                    self.record_success(r, None)
                else:
                    self.record_failure(r, now)

    def health_snapshot(self) -> dict:
        with self.lock:
            return {r.name: r.health() for r in self.replicas}
