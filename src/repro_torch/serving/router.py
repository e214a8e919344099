"""Health-checked query router over a replica set, with hedged requests,
failover, and zero-downtime rolling index updates.

The port of the JAX package's ``serving/router.py``: the same dispatch,
hedging, failover, generation guard and rolling-update state machine.

The router duck-types the engine's serving surface — ``submit`` /
``pending_requests`` / ``drain`` / ``result`` — so the open-loop traffic
driver and ``launch/serve.py`` run unchanged against N replicas. Scheduling
stays centralized: the router owns one :class:`~.scheduler.Scheduler`
(admission control, weighted-fair tenants, dynamic batch sizing) and
dispatches each admitted batch onto one replica engine via
:meth:`~.engine.RetrievalEngine.execute_chunk`, on a small thread pool so
replicas serve concurrently and a straggling batch can be *hedged*:

* **Hedging** — once enough batch latencies are observed, a dispatch that
  has not answered within the ``hedge_quantile`` latency deadline is
  re-sent to a second replica serving the *same index generation*. The
  first non-degraded answer wins; the loser's answers are discarded
  bit-safely (never delivered, never cached at router level — replicas at
  one generation are bit-identical, so the winner's bytes are the loser's
  bytes). Hedging loses when load is high (no idle replica to hedge onto)
  or batches are tiny (the deadline floor dominates); see DESIGN.md.
* **Failover** — a dispatch that errors (or lands on a replica killed
  mid-flight) is retried on the next-best replica, bounded by
  ``max_retries``; a degraded answer is kept as fallback rather than
  retried. When every attempt fails the batch is shed with a structured
  ``"no_replica"`` reason — the router-level rung below the engine's own
  degradation ladder (which already ran inside each attempt).
* **Zero wrong-generation answers** — every answer is stamped by its
  engine with the generation that computed it; the router verifies the
  stamp against the generation captured at dispatch and discards (then
  fails over) on mismatch. During a rolling update the mixed-generation
  window is explicit: :meth:`QueryRouter.generation_window` reports the
  live span.

**Rolling updates** (:meth:`RouterControl.apply_updates`) drain and update
one replica at a time behind the health mask: mask the replica from
routing, wait for its in-flight batches (hedge losers included) to finish,
run the engine's transactional ``apply_updates`` off-thread, unmask, move
on. At most one replica is ever masked, so N-1 replicas keep serving —
zero downtime. Dead/killed replicas are skipped and marked *stale* (they
never rejoin routing at the wrong generation). A failed per-replica update
is retried once, then the replica is marked stale and the roll continues.
Once the roll completes every replica serves the new generation and
results are bit-identical to a single updated engine.

**Threads on one card.** The pool threads run ``engine.execute_chunk`` at
once. Each engine owns a CUDA stream and runs every batch on it in
whichever thread calls it (``RetrievalEngine._on_stream``), so two
replicas on one card launch on two streams and one replica's wait is not a
wait for the other's batch; the kernels give the same answers on any
stream, so a replica's answers are a single engine's, bit for bit. The
state the threads share is guarded: the kernels' launch counters and the
loaded libraries take a lock (``kernels.launch``, ``kernels.build``), and
:meth:`QueryRouter.warmup` builds and loads every kernel library before
any batch is dispatched, so no pool thread runs ``nvcc``. It also captures
each engine's query-path CUDA graphs (``core.graphs``; keyed on the engine's
stream, so two replicas sharing device leaves never replay one graph) before
the threads serve. A capture runs one at a time in the process, in
``capture_error_mode="thread_local"``, so the re-capture of a rolling update
in one pool thread never trips on another thread's launches.

**A replica killed mid-flight.** ``execute_chunk`` returns only after the
engine's stream has finished the batch (it waits on its stream, and on a
host-tier index every pipeline slot's copies have completed), so a killed
replica's answers are discarded after its card work is done: its pinned
slots are never written while one of its copies is pending.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from .. import faults
from ..kernels import build
from .engine import EVICTED, QueryResult, Shed
from .replica import DEAD, HEALTHY, HealthPolicy, ReplicaDead, ReplicaSet
from .scheduler import DEFAULT_TENANT, Request, Scheduler, SchedulerConfig

import threading


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router knobs.

    ``hedge_quantile`` sets the hedging deadline as a quantile of recent
    per-batch service times (``None`` disables hedging); the deadline
    never drops below ``hedge_floor_s`` and hedging stays off until
    ``hedge_min_samples`` batches have been observed. ``max_retries``
    bounds failover re-dispatches per batch (attempts = 1 + retries).
    ``deadline_s``/``max_queue`` feed the router scheduler's admission
    control, mirroring the engine's ``DegradePolicy`` knobs.
    """

    hedge_quantile: Optional[float] = 0.95
    hedge_min_samples: int = 12
    hedge_floor_s: float = 1e-3
    max_retries: int = 2
    deadline_s: Optional[float] = None
    max_queue: Optional[int] = None
    max_results: int = 65536


@dataclasses.dataclass
class RouterStats:
    """Router-level accounting (per-engine stats live on each replica)."""

    n_queries: int = 0  # answered (delivered, non-shed) requests
    n_batches: int = 0
    n_shed: int = 0  # admission sheds + no-replica sheds
    n_dispatches: int = 0  # batch->replica attempts (hedges/retries incl.)
    n_dispatch_failures: int = 0
    n_failovers: int = 0  # batches re-dispatched after a failed attempt
    n_hedges: int = 0
    n_hedge_wins: int = 0  # hedge answered first (non-degraded)
    n_hedge_losses: int = 0  # hedged batch answered by the primary
    n_wrong_generation: int = 0  # answers discarded by the generation guard
    n_replica_kills: int = 0
    n_degraded: int = 0
    n_rolls_started: int = 0
    n_rolls_completed: int = 0
    n_roll_replicas_updated: int = 0
    n_roll_replicas_skipped: int = 0  # dead/failed replicas marked stale
    n_roll_update_failures: int = 0
    recent_latency_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=4096)
    )
    # Per-dispatch wall times (stragglers included) — the hedging
    # deadline's sample distribution.
    recent_batch_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=512)
    )

    @property
    def availability(self) -> float:
        """Fraction of finished requests that got an answer (vs shed)."""
        return self.n_queries / max(self.n_queries + self.n_shed, 1)

    def latency_quantile(self, q: float) -> float:
        if not self.recent_latency_s:
            return 0.0
        return float(np.quantile(np.asarray(self.recent_latency_s), q))


class QueryRouter:
    """Spread scheduler batches across a health-tracked replica set.

    ``engines`` is a list of :class:`~.engine.RetrievalEngine` (or
    ``(name, engine)`` pairs, or a prebuilt :class:`ReplicaSet`). Replicas
    should be built identically (same params) — the fleet guarantees
    assume one logical index. ``fault_plan`` drives the ``replica_*``
    chaos sites and is fired directly (not via the module-global
    activation) so worker-thread timing never changes the schedule.
    """

    def __init__(
        self,
        engines,
        *,
        config: RouterConfig | None = None,
        health: HealthPolicy | None = None,
        scheduler: SchedulerConfig | None = None,
        fault_plan=None,
    ):
        self.cfg = config if config is not None else RouterConfig()
        self.fault_plan = fault_plan
        self._lock = threading.RLock()
        if isinstance(engines, ReplicaSet):
            self.replicas = engines
            self.replicas.lock = self._lock
            if self.replicas.fault_plan is None:
                self.replicas.fault_plan = fault_plan
        else:
            self.replicas = ReplicaSet(
                engines,
                policy=health,
                fault_plan=fault_plan,
                lock=self._lock,
            )
        first = self.replicas.replicas[0].engine
        self.batch_size = first.batch_size
        self.k = first.k
        self.sched_cfg = (
            scheduler if scheduler is not None else SchedulerConfig()
        )
        if self.sched_cfg.cache_size:
            # Result caching stays per-engine: a router-level cache would
            # need its own cross-replica generation keying for no win.
            self.sched_cfg = dataclasses.replace(
                self.sched_cfg, cache_size=0
            )
        self.scheduler = Scheduler(
            self.sched_cfg,
            batch_size=self.batch_size,
            deadline_s=self.cfg.deadline_s,
            max_queue=self.cfg.max_queue,
        )
        self.stats = RouterStats()
        self.results: collections.OrderedDict = collections.OrderedDict()
        self._evicted: collections.OrderedDict = collections.OrderedDict()
        self._next_id = 0
        self._seq = 0  # dispatch sequence for LRU round-robin
        self._roll: Optional[dict] = None
        # One worker per replica covers full fan-out; +2 leaves headroom
        # for a hedge racing a straggler plus a rolling-update task.
        self._pool = cf.ThreadPoolExecutor(
            max_workers=len(self.replicas) + 2,
            thread_name_prefix="router",
        )
        self.control = RouterControl(self)

    # -- engine-compatible serving surface ---------------------------------

    @property
    def pending_requests(self) -> int:
        return len(self.scheduler)

    def warmup(self, *, warm_ladder: bool = True) -> None:
        """Build and load every kernel library (on the card), then warm
        each replica's engine: no pool thread builds or loads a library."""
        if any(r.engine.device.type == "cuda" for r in self.replicas):
            build.load_all()
        for r in self.replicas:
            r.engine.warmup(warm_ladder=warm_ladder)

    def submit(self, query, *, tenant: str = DEFAULT_TENANT) -> int:
        rid = self._next_id
        self._next_id += 1
        vec = np.asarray(query, np.float32)
        req = Request(
            rid=rid,
            query=vec,
            t_submit=time.perf_counter(),
            tenant=tenant,
            fp=self.scheduler.fingerprint(vec),
        )
        reason = self.scheduler.admit(req)
        if reason is not None:
            with self._lock:
                self.stats.n_shed += 1
                self._put_result(rid, Shed(rid=rid, reason=reason))
        return rid

    def drain(self, max_dispatches: int | None = None) -> None:
        """Dispatch queued batches across the fleet; also the router's
        clock tick — fires the ``replica_kill`` site once per call,
        advances health reprobes, and steps any in-flight rolling update."""
        self._maybe_kill()
        self.replicas.tick()
        self._advance_roll()
        n_disp = 0
        while len(self.scheduler):
            if max_dispatches is not None and n_disp >= max_dispatches:
                break
            chunk = self.scheduler.take(self.scheduler.pick_batch_size())
            if not chunk:
                break
            n_disp += 1
            self._dispatch_batch(chunk)
            self._advance_roll()

    def result(self, rid: int, *, keep: bool = False):
        if rid in self._evicted:
            return EVICTED
        if keep:
            return self.results.get(rid)
        return self.results.pop(rid, None)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def generation_window(self) -> tuple:
        """(min, max) index generation across serveable replicas — the
        explicit mixed-generation window during a rolling update (equal
        outside one)."""
        with self._lock:
            gens = [r.generation for r in self.replicas if r.serveable()]
        if not gens:
            return (None, None)
        return (min(gens), max(gens))

    def stats_dict(self) -> dict:
        """JSON-friendly snapshot: router counters + per-replica health."""
        d = {
            f.name: getattr(self.stats, f.name)
            for f in dataclasses.fields(RouterStats)
            if not isinstance(getattr(self.stats, f.name), collections.deque)
        }
        d["availability"] = self.stats.availability
        d["p50_s"] = self.stats.latency_quantile(0.5)
        d["p99_s"] = self.stats.latency_quantile(0.99)
        lo, hi = self.generation_window()
        d["generation_window"] = [lo, hi]
        d["rolling_update_active"] = self._roll is not None
        d["n_heartbeats"] = self.replicas.n_heartbeats
        d["n_heartbeat_misses"] = self.replicas.n_heartbeat_misses
        d["replicas"] = self.replicas.health_snapshot()
        return d

    # -- dispatch ----------------------------------------------------------

    def _put_result(self, rid: int, value) -> None:
        self.results[rid] = value
        while len(self.results) > self.cfg.max_results:
            old_rid, _ = self.results.popitem(last=False)
            self._evicted[old_rid] = None
            while len(self._evicted) > self.cfg.max_results:
                self._evicted.popitem(last=False)

    def _dispatch_batch(self, chunk: list) -> None:
        """Run one batch to an answer: primary dispatch, hedge after the
        latency-quantile deadline, bounded failover, then shed."""
        with self._lock:
            self.stats.n_batches += 1
        fallback = None  # first degraded (answers, rep, dt) seen
        tried: list[str] = []
        for attempt in range(self.cfg.max_retries + 1):
            if attempt > 0:
                with self._lock:
                    self.stats.n_failovers += 1
            primary = self.replicas.pick(exclude=tried)
            if primary is None:
                # Whole fleet tried once: retries may revisit replicas.
                primary = self.replicas.pick()
            if primary is None:
                break  # nothing serveable at all
            fut, gen = self._launch(primary, chunk)
            futures = {fut: (primary, gen)}
            if primary.name not in tried:
                tried.append(primary.name)
            hedge = None
            deadline = self._hedge_deadline()
            if deadline is not None:
                done, _ = cf.wait([fut], timeout=deadline)
                if not done:
                    # Straggler: race a second replica at the SAME
                    # generation so either answer is bit-safe to deliver.
                    # Idle replicas only — a busy candidate would queue
                    # behind its in-flight batch and lose the race.
                    hedge = self.replicas.pick(
                        exclude=tried, generation=gen, idle_only=True
                    )
                    if hedge is not None:
                        with self._lock:
                            self.stats.n_hedges += 1
                        hfut, hgen = self._launch(hedge, chunk)
                        futures[hfut] = (hedge, hgen)
                        tried.append(hedge.name)
            winner = None
            while futures and winner is None:
                done, _ = cf.wait(
                    list(futures), return_when=cf.FIRST_COMPLETED
                )
                for f in done:
                    rep, g = futures.pop(f)
                    settled = self._settle(f, rep, g)
                    if settled is None:
                        continue  # failed attempt (health recorded)
                    answers, dt = settled
                    if all(a.degraded for a in answers):
                        # Keep as fallback; a non-degraded answer from the
                        # other in-flight attempt still wins.
                        if fallback is None:
                            fallback = (answers, rep, dt)
                        continue
                    winner = (answers, rep, dt)
                    break
            for f, (rep, g) in futures.items():
                # Bit-safe discard: the loser finishes in the background,
                # contributes health/latency signal, delivers nothing.
                f.add_done_callback(self._discard_cb(rep, g))
            if winner is not None:
                answers, rep, dt = winner
                self._deliver(chunk, answers, rep, dt, hedge_win=rep is hedge)
                return
            if fallback is not None:
                answers, rep, dt = fallback
                self._deliver(chunk, answers, rep, dt, hedge_win=False)
                return
        # Bounded retries exhausted below the engines' own degradation
        # ladders: answer structurally rather than hang.
        self._shed_chunk(chunk, "no_replica")

    def _launch(self, rep, chunk):
        """Submit one dispatch attempt; returns (future, generation at
        dispatch) — the stamp every answer must match."""
        gen = rep.engine.generation
        with self._lock:
            self._seq += 1
            rep.last_used = self._seq
            rep.outstanding += 1
            self.stats.n_dispatches += 1
        self._set_rung(rep)
        return self._pool.submit(self._run_on, rep, chunk), gen

    def _run_on(self, rep, chunk):
        """Worker-thread body: fire the dispatch fault site, execute the
        batch under the replica's lock, re-check liveness."""
        t0 = time.perf_counter()
        try:
            plan = self.fault_plan
            if plan is not None:
                spec = plan.fire(faults.REPLICA_DISPATCH)
                if spec is not None and faults.spec_targets(spec, rep.name):
                    if spec.mode == "straggle":
                        time.sleep(spec.delay_s)
                    elif spec.mode == "fail":
                        raise faults.InjectedFault(
                            faults.REPLICA_DISPATCH,
                            f"injected dispatch failure on {rep.name!r}",
                        )
            if rep.killed:
                raise ReplicaDead(rep.name)
            with rep.lock:
                if rep.killed:
                    raise ReplicaDead(rep.name)
                answers = rep.engine.execute_chunk(list(chunk))
            if rep.killed:
                # Killed mid-flight: the device may have answered, but the
                # replica is gone — fail over instead of delivering.
                raise ReplicaDead(
                    rep.name, f"replica {rep.name!r} killed mid-flight"
                )
            return answers, time.perf_counter() - t0
        finally:
            with self._lock:
                rep.outstanding -= 1

    def _settle(self, fut, rep, gen):
        """Resolve one finished attempt: record health, verify the
        generation stamp. Returns (answers, dt) or None on failure."""
        try:
            answers, dt = fut.result()
        except Exception:
            with self._lock:
                self.stats.n_dispatch_failures += 1
            self.replicas.record_failure(rep)
            return None
        self.replicas.record_success(rep, dt)
        with self._lock:
            self.stats.recent_batch_s.append(dt)
        bad = sum(
            1
            for a in answers
            if isinstance(a, QueryResult) and a.generation != gen
        )
        if bad:
            # The wrong-generation guard: an update raced this dispatch
            # (e.g. apply_updates called directly on the engine, outside
            # RouterControl). Discard and fail over — never deliver.
            with self._lock:
                self.stats.n_wrong_generation += bad
            return None
        return answers, dt

    def _discard_cb(self, rep, gen):
        def cb(fut):
            if self._settle(fut, rep, gen) is not None:
                with self._lock:
                    self.stats.n_hedge_losses += 1

        return cb

    def _deliver(self, chunk, answers, rep, dt, *, hedge_win):
        with self._lock:
            self.stats.n_queries += len(chunk)
            if hedge_win:
                self.stats.n_hedge_wins += 1
            for req, a in zip(chunk, answers):
                if isinstance(a, QueryResult):
                    a.replica = rep.name
                    if a.degraded:
                        self.stats.n_degraded += 1
                    if a.latency_s is not None:
                        self.stats.recent_latency_s.append(a.latency_s)
                self._put_result(req.rid, a)
        self.scheduler.observe_service(len(chunk), dt)

    def _shed_chunk(self, chunk, reason: str) -> None:
        with self._lock:
            self.stats.n_shed += len(chunk)
            for req in chunk:
                self._put_result(req.rid, Shed(rid=req.rid, reason=reason))

    def _hedge_deadline(self) -> Optional[float]:
        q = self.cfg.hedge_quantile
        if q is None or self.replicas.n_serveable() < 2:
            return None
        with self._lock:
            if len(self.stats.recent_batch_s) < self.cfg.hedge_min_samples:
                return None
            lat = np.asarray(self.stats.recent_batch_s)
        return max(float(np.quantile(lat, q)), self.cfg.hedge_floor_s)

    def _set_rung(self, rep) -> None:
        """Per-replica operating point: navigate the replica's materialized
        ``select_operating_point`` chain (``DegradePolicy.ladder``, built
        from the swept Pareto frontier) by the scheduler's load signal,
        stepping one rung cheaper on a not-fully-healthy replica while it
        proves itself out."""
        ladder = getattr(rep.engine.policy, "ladder", ())
        if not ladder or self.sched_cfg.slo_s is None:
            return
        load = self.scheduler.load_signal(time.perf_counter())
        target = min(int(round(load * len(ladder))), len(ladder))
        if rep.state != HEALTHY:
            target = min(target + 1, len(ladder))
        rep.engine.rung = target

    # -- chaos hooks -------------------------------------------------------

    def _maybe_kill(self) -> None:
        """Fire the ``replica_kill`` site (once per drain call)."""
        plan = self.fault_plan
        if plan is None:
            return
        spec = plan.fire(faults.REPLICA_KILL)
        if spec is None or spec.mode != "kill_replica":
            return
        payload = spec.payload if isinstance(spec.payload, dict) else {}
        name = payload.get("replica")
        if name is None:
            live = [r for r in self.replicas if not r.killed]
            if not live:
                return
            name = live[0].name
        try:
            rep = self.replicas.get(name)
        except KeyError:
            return
        if not rep.killed:
            self.replicas.kill(name)
            with self._lock:
                self.stats.n_replica_kills += 1

    # -- rolling updates ---------------------------------------------------

    def _advance_roll(self) -> None:
        """One step of the rolling-update state machine (driven from
        ``drain``): finish/react to an in-flight per-replica update, else
        mask the next eligible replica, wait out its in-flight batches,
        and launch its transactional update off-thread."""
        with self._lock:
            roll = self._roll
        if roll is None:
            return
        fut = roll["future"]
        if fut is not None:
            if not fut.done():
                return
            rep = roll["replica"]
            roll["future"] = None
            roll["replica"] = None
            try:
                fut.result()
            except Exception:
                with self._lock:
                    self.stats.n_roll_update_failures += 1
                # The engine rolled its transaction back (old generation
                # intact). Retry once; then drop the replica from the
                # fleet rather than stall the roll.
                if rep.name not in roll["retried"]:
                    roll["retried"].add(rep.name)
                else:
                    with self._lock:
                        rep.stale = True
                        rep.updating = False
                        self.stats.n_roll_replicas_skipped += 1
                    roll["i"] += 1
            else:
                with self._lock:
                    rep.updating = False
                    self.stats.n_roll_replicas_updated += 1
                roll["i"] += 1
            return
        order = roll["order"]
        while roll["i"] < len(order):
            cand = self.replicas.get(order[roll["i"]])
            # Eligibility checks actual health, NOT serveable(): the roll
            # itself sets the `updating` mask, which must not read as
            # ill-health when a failed first attempt comes back for its
            # retry.
            if cand.killed or cand.stale or cand.state == DEAD:
                # Skipped behind the health mask. Mark stale: if it later
                # recovered it would serve the pre-roll generation.
                with self._lock:
                    if not cand.stale:
                        cand.stale = True
                        self.stats.n_roll_replicas_skipped += 1
                roll["i"] += 1
                continue
            break
        if roll["i"] >= len(order):
            with self._lock:
                self._roll = None
                self.stats.n_rolls_completed += 1
            return
        cand = self.replicas.get(order[roll["i"]])
        with self._lock:
            cand.updating = True  # mask from routing before waiting idle
            busy = cand.outstanding > 0
        if busy:
            return  # in-flight batches (hedge losers too) must finish
        roll["replica"] = cand
        roll["future"] = self._pool.submit(
            self._locked_update, cand, roll["update_fn"]
        )

    @staticmethod
    def _locked_update(rep, update_fn):
        # The replica lock serializes the swap against any execute_chunk
        # that raced past the updating mask; the generation guard would
        # catch (and discard) such an answer either way.
        with rep.lock:
            return rep.engine.apply_updates(update_fn)


class RouterControl:
    """Operator control plane: rolling index updates over the fleet."""

    def __init__(self, router: QueryRouter):
        self.router = router

    @property
    def rolling(self) -> bool:
        return self.router._roll is not None

    def apply_updates(
        self,
        update_fn: Callable,
        *,
        block: bool = True,
        poll_s: float = 2e-3,
        timeout: Optional[float] = None,
    ) -> None:
        """Start a rolling update: every live replica is drained and
        updated in turn, one at a time (zero downtime — N-1 replicas keep
        serving throughout). ``update_fn`` must be deterministic: it runs
        once per replica and post-roll bit-identity across the fleet (and
        vs a single updated engine) depends on it. With ``block=False``
        the roll advances inside subsequent ``drain`` calls — serving
        continues while the fleet rolls; use :meth:`wait` to finish."""
        r = self.router
        with r._lock:
            if r._roll is not None:
                raise RuntimeError("a rolling update is already in flight")
            r._roll = {
                "update_fn": update_fn,
                "order": [rep.name for rep in r.replicas],
                "i": 0,
                "replica": None,
                "future": None,
                "retried": set(),
            }
            r.stats.n_rolls_started += 1
        if block:
            self.wait(poll_s=poll_s, timeout=timeout)

    def wait(
        self, *, poll_s: float = 2e-3, timeout: Optional[float] = None
    ) -> None:
        """Pump drains until the in-flight roll completes (queued traffic
        keeps being served while waiting)."""
        r = self.router
        t0 = time.perf_counter()
        while True:
            r.drain()
            with r._lock:
                if r._roll is None:
                    return
            if timeout is not None and time.perf_counter() - t0 > timeout:
                raise TimeoutError("rolling update did not complete")
            time.sleep(poll_s)
