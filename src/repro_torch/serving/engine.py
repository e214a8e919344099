"""Batched retrieval serving engine.

The port of the JAX package's ``serving/engine.py``. It wraps an index
backend behind one API: ``submit`` queues requests, ``drain`` executes them
in batches, and AQT (average query time, the paper's efficiency metric) is
measured here.

A :class:`~.scheduler.Scheduler` decides admission, per-tenant fairness,
result-cache hits and the batch size of each dispatch; the engine owns
execution (:meth:`RetrievalEngine._execute_batch`), the pipelined host-tier
drain, the degradation ladder and transactional updates. The default
``SchedulerConfig`` is the fixed-batch FIFO engine.

Backends share the signature ``search(queries (B, d), k) -> TopK``; an
*updatable* LIDER backend takes ``search(params, queries, k)`` and the
engine owns the served params, so ``apply_updates`` can swap them between
batches.

On a host-tier index (``rescore_tier="host"``) the drain is pipelined
across batches, as the JAX engine's is, but PyTorch has to be told what
JAX's asynchronous dispatch does alone. Each pipeline slot (:class:`_Slot`)
owns pinned host buffers: the batch's queries go to the card and its
provisional rows come back with asynchronous copies, and an event after the
rows' copy is the only thing the host waits on before it gathers the exact
rows, so batch i's gather runs while batch i+1's first pass is on the card.
The gathered rows go to the card from a pinned staging buffer on a side
stream; the compute stream waits on that copy's event before the rescore,
and a staging buffer is written again only after its copy's event has
fired. On the CPU the same steps run synchronously on plain tensors.

Every backend of the JAX engine is here: ``lider``, ``flat``, ``pq``,
``ivfpq``, ``sklsh`` and ``mplsh``. The JAX engine's ``use_fused`` and
``block_c`` knobs are not: ``kernels.ops`` dispatches by device.

On the card the query path's entries replay CUDA graphs (``core.graphs``),
one per signature, keyed on the engine's stream: :meth:`RetrievalEngine.warmup`
runs every batch size, rung, slot and block_q choice, so it captures them
all, and a batch after it only replays. The fetched rows land in each
slot's fixed staging buffer on the card, which the rescore's graph reads
where it lies. An update that makes new device leaves of the same shapes
captures the warmed signatures again on the new leaves before they are
served, and frees the superseded graphs.

On the card each engine owns a CUDA stream, made when the engine is, and
runs every batch, warm-up and update on it, in whichever thread calls it
(:meth:`RetrievalEngine._on_stream`). PyTorch's current stream belongs to a
thread, so a router's pool threads would otherwise all launch on the
device's default stream, and one replica's wait would also wait for the
other's batch. The engine's stream first waits for the caller's stream
(the params were built there), and the caller's stream waits for the
engine's on the way out; the answers are the same on any stream.

With tracing on (``obs.enable``) the engine's shared steps are profiler
spans, in the serial and the pipelined drain alike:
``repro_torch.engine.submit``, ``.take`` (the batch popped from the
scheduler), ``.stage`` (padded, filled and copied to the card), ``.search``
(the search, or the staged first pass), ``.wait`` (the device) and
``.record`` (answers copied to the host and routed, counters). The
``EngineStats`` counters are always on; ``queue_wait_s`` sums the requests'
waits from submit to the take that batched them.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import random
import time
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from .. import faults, obs
from ..core import graphs
from ..core import lider as lider_lib
from ..core.baselines import flat_search, ivfpq_search, mplsh_search, pq_search, sklsh_search
from ..core.core_model import TopK
from ..core.types import tensor_leaves
from ..device import resolve_device
from .scheduler import DEFAULT_TENANT, Request, Scheduler, SchedulerConfig


@dataclasses.dataclass
class EngineStats:
    n_queries: int = 0
    n_batches: int = 0
    total_time_s: float = 0.0
    n_padded: int = 0  # pad slots executed for partial batches
    # Adaptive probe pruning: probes routed by layer 1 but masked by the
    # margin rule. Per-batch traces are bounded deques (newest batches);
    # lifetime aggregates live in counters.
    n_probes_total: int = 0
    n_probes_pruned: int = 0
    batch_pruned_fraction: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=256)
    )
    n_results_evicted: int = 0  # results dropped by the bounded results map
    # Tiered serving: host gathers of exact rows. A fetch is "overlapped"
    # when the next batch's first pass was dispatched to the device before
    # the fetch ran, and "under device work" when, as its gather began, the
    # device was still running that pass (its CUDA event had not fired; 0
    # on the CPU). ``host_fetch_bytes`` are the rows gathered (and copied
    # to the card); ``h2d_s`` is the copies' device time, from CUDA events
    # (0 on the CPU, where there is no copy).
    host_fetch_us: float = 0.0
    n_host_fetches: int = 0
    n_overlapped_fetches: int = 0
    n_fetches_under_device_work: int = 0
    host_fetch_bytes: int = 0
    h2d_s: float = 0.0
    # Fault tolerance: update transactions, host-fetch retry/degrade,
    # admission control, deadline accounting.
    n_update_rollbacks: int = 0  # failed apply_updates rolled back
    n_fetch_retries: int = 0  # host fetches retried after a failure
    n_fetch_failures: int = 0  # batches whose fetch exhausted all retries
    n_degraded: int = 0  # queries answered compressed-only (degraded=True)
    n_shed: int = 0  # requests rejected by admission control
    n_deadline_misses: int = 0  # answered, but past the per-request deadline
    n_rung_steps: int = 0  # degradation-ladder step-downs
    # Front-end scheduler counters. Cache hits count in n_queries (they are
    # answered traffic) but add no device time.
    n_cache_hits: int = 0
    n_cache_misses: int = 0  # admitted-to-queue (executed on device)
    batch_size_trace: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=256)
    )
    recent_latency_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=1024)
    )
    # Seconds from a batch's dispatch to its answers (newest batches).
    batch_latency_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=256)
    )
    # Cluster-major schedule accounting: scheduled (query, probe) pairs vs
    # the grouped-kernel steps that served them (the block_q tuner's input).
    n_sched_pairs: int = 0
    n_sched_steps: int = 0
    # Seconds requests waited in the engine's queue, from their submit to
    # the take that put them in a batch, summed over the requests taken
    # (cache hits excluded), and the number of requests that sum covers.
    queue_wait_s: float = 0.0
    n_queue_waits: int = 0

    @property
    def aqt(self) -> float:
        return self.total_time_s / max(self.n_queries, 1)

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of answered (non-shed) requests served from the cache."""
        return self.n_cache_hits / max(self.n_cache_hits + self.n_cache_misses, 1)

    def latency_quantile(self, q: float) -> float:
        """Request latency quantile (e.g. 0.5 / 0.99) over the recent window."""
        if not self.recent_latency_s:
            return 0.0
        return float(np.quantile(np.asarray(self.recent_latency_s), q))

    def batch_latency_quantile(self, q: float) -> float:
        """Dispatch-to-answer batch latency quantile over the recent window."""
        if not self.batch_latency_s:
            return 0.0
        return float(np.quantile(np.asarray(self.batch_latency_s), q))

    @property
    def overlap_fraction(self) -> float:
        """Fraction of host fetches that ran under a dispatched next batch."""
        return self.n_overlapped_fetches / max(self.n_host_fetches, 1)

    @property
    def measured_overlap_fraction(self) -> float:
        """Fraction of host fetches whose gather began while the device was
        still running the next batch's first pass (0 on the CPU)."""
        return self.n_fetches_under_device_work / max(self.n_host_fetches, 1)

    @property
    def gather_gb_per_s(self) -> float:
        """Host gather rate of the exact rows, GB/s."""
        return self.host_fetch_bytes / max(self.host_fetch_us, 1e-9) / 1e3

    @property
    def h2d_gb_per_s(self) -> float:
        """Host-to-device rate of the fetched rows, GB/s (0 on the CPU)."""
        return self.host_fetch_bytes / self.h2d_s / 1e9 if self.h2d_s else 0.0

    @property
    def padding_fraction(self) -> float:
        """Fraction of executed batch slots that were padding (wasted work)."""
        return self.n_padded / max(self.n_queries + self.n_padded, 1)

    @property
    def pruned_probe_fraction(self) -> float:
        """Fraction of routed probes the margin rule pruned (all batches)."""
        return self.n_probes_pruned / max(self.n_probes_total, 1)

    @property
    def sharing_ratio(self) -> float:
        """Scheduled pairs per grouped-kernel step over all cluster-major
        batches (>= 1; 1.0 means no two queries shared a cluster)."""
        return self.n_sched_pairs / max(self.n_sched_steps, 1)


class QueryResult:
    """One answered request. Unpacks like an ``(ids, scores)`` pair and
    carries: ``degraded`` (answered compressed-only, no exact rescore),
    ``rung`` (the degradation-ladder rung it was served at, 0 = nominal),
    ``latency_s`` (submit to answer), ``cached`` (from the result cache,
    bit-identical to a fresh search at the same generation and rung),
    ``generation`` (the engine generation it was computed at) and
    ``replica`` (the serving replica, when a router dispatched it)."""

    __slots__ = (
        "ids", "scores", "degraded", "rung", "latency_s", "cached",
        "generation", "replica",
    )

    def __init__(
        self, ids, scores, *, degraded=False, rung=0, latency_s=0.0,
        cached=False, generation=None, replica=None,
    ):
        self.ids = ids
        self.scores = scores
        self.degraded = degraded
        self.rung = rung
        self.latency_s = latency_s
        self.cached = cached
        self.generation = generation
        self.replica = replica

    def __iter__(self):
        return iter((self.ids, self.scores))

    def __getitem__(self, i):
        return (self.ids, self.scores)[i]

    def __len__(self):
        return 2

    def __repr__(self):
        tag = f", degraded rung={self.rung}" if self.degraded else ""
        return f"QueryResult(k={len(np.asarray(self.ids))}{tag})"


@dataclasses.dataclass(frozen=True)
class Shed:
    """Structured rejection by admission control; ``result(rid)`` returns
    it for shed rids."""

    rid: int
    reason: str = "queue_full"


class _EvictedType:
    """Singleton sentinel: the answer existed but was evicted by the
    bounded results map. Falsy, and distinct from ``None`` (never submitted
    or already collected)."""

    def __repr__(self):
        return "EVICTED"

    def __bool__(self):
        return False


EVICTED = _EvictedType()


def _numpy(x) -> np.ndarray:
    """A result array on the host (the device-to-host copy of a tensor)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Slot:
    """One pipeline slot of the host-tier drain: its host buffers and the
    events that say when each may be read or written again.

    On the card the buffers are pinned and grow to the largest batch seen:
    ``queries`` (copied to the card), ``rows`` (the provisional rows copied
    back; ``rows_ready`` fires after that copy) and ``staging`` (the
    gathered exact rows, copied to the card on the engine's side stream
    between ``copy_start`` and ``copied``, into the card's ``staging``
    buffer of ``device_buffers``, which a graph reads where it lies). On
    the CPU the same methods pass plain tensors through.
    """

    def __init__(self, device: torch.device, copy_stream):
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy_stream = copy_stream
        self.buffers: dict[str, torch.Tensor] = {}
        self.device_buffers: dict[str, torch.Tensor] = {}
        self.copy_pending = False
        if self.cuda:
            self.rows_ready = torch.cuda.Event()
            self.copy_start = torch.cuda.Event(enable_timing=True)
            self.copied = torch.cuda.Event(enable_timing=True)

    def buffer(self, name: str, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        n = math.prod(shape)
        buf = self.buffers.get(name)
        if buf is None or buf.numel() < n or buf.dtype != dtype:
            buf = torch.empty(n, dtype=dtype, pin_memory=self.cuda)
            self.buffers[name] = buf
        return buf[:n].view(shape)

    def device_buffer(self, name: str, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """A buffer on the card that grows to the largest batch seen,
        registered with ``graphs.persistent``: the graphs bind its address
        rather than copy it at each replay."""
        n = math.prod(shape)
        buf = self.device_buffers.get(name)
        if buf is None or buf.numel() < n or buf.dtype != dtype:
            buf = graphs.persistent(torch.empty(n, dtype=dtype, device=self.device))
            self.device_buffers[name] = buf
        return buf[:n].view(shape)

    def queries_to_device(self, q: np.ndarray) -> torch.Tensor:
        if not self.cuda:
            return torch.tensor(q)  # a copy: the engine refills ``q``
        host = self.buffer("queries", q.shape, torch.float32)
        host.copy_(torch.from_numpy(q))
        # Reusing ``host`` is safe: the next batch of this slot is
        # dispatched after this one's ``rows_ready``, which follows this
        # copy on the compute stream.
        return host.to(self.device, non_blocking=True)

    def rows_to_host(self, rows: torch.Tensor) -> torch.Tensor:
        """Start the copy of the provisional rows to the host; the host
        reads the result only after :meth:`wait_rows`."""
        if not self.cuda:
            return rows
        host = self.buffer("rows", tuple(rows.shape), rows.dtype)
        host.copy_(rows, non_blocking=True)
        self.rows_ready.record()
        return host

    def wait_rows(self) -> None:
        """Wait for the provisional rows' copy alone, not for the work the
        compute stream was given after it."""
        if self.cuda:
            self.rows_ready.synchronize()

    def stage1_running(self) -> bool:
        """Whether the device has yet to finish this slot's first pass (the
        rows' copy queued after it has not completed); False on the CPU."""
        return self.cuda and not self.rows_ready.query()

    def staging_for(self, shape: tuple) -> torch.Tensor | None:
        """The staging buffer for ``shape`` fetched rows, once its previous
        copy to the card has finished (None on the CPU: the fetch
        allocates)."""
        if not self.cuda:
            return None
        if self.copy_pending:
            self.copied.synchronize()
            self.copy_pending = False
        return self.buffer("staging", shape, torch.float32)

    def to_device(self, fetched: torch.Tensor) -> torch.Tensor:
        """Copy the fetched rows to the card on the side stream; the
        compute stream waits for the copy before it uses the result."""
        if not self.cuda:
            return fetched
        # The slot's fixed buffer on the card. Its last reader, this slot's
        # previous rescore, has finished: the engine waits for the compute
        # stream after every rescore, before the slot is used again.
        dev = self.device_buffer("staging", tuple(fetched.shape), fetched.dtype)
        with torch.cuda.stream(self.copy_stream):
            self.copy_start.record()
            dev.copy_(fetched, non_blocking=True)
            self.copied.record()
        self.copy_pending = True
        torch.cuda.current_stream(self.device).wait_event(self.copied)
        return dev

    def copy_seconds(self) -> float:
        """Device time of the last copy to the card; call after it is done."""
        return self.copy_start.elapsed_time(self.copied) / 1e3 if self.cuda else 0.0


@dataclasses.dataclass
class _PendingBatch:
    """One stage-1-dispatched batch in the host-tier pipeline. ``rung``/
    ``bs`` are captured at dispatch (the live rung may step before the
    batch finishes); ``rows`` are its provisional rows on the host (valid
    after ``slot.wait_rows()``); ``retry_at`` is the earliest wall time a
    failed fetch may be retried (None = ready now); ``overlap_armed`` is set
    when a later batch's stage 1 was dispatched under this batch's fetch,
    and ``next_slot`` is that batch's slot."""

    chunk: list
    bs: int
    q: torch.Tensor
    prov: TopK
    pruned: object
    rung: int
    slot: _Slot
    rows: torch.Tensor
    t_dispatch: float
    attempts: int = 0
    retry_at: Optional[float] = None
    overlap_armed: bool = False
    next_slot: Optional[_Slot] = None
    blocked: bool = False


# Operating-point knobs a degradation-ladder rung may override; anything
# else in a rung dict (e.g. a modeled ``expected_recall``) is report
# metadata the engine ignores.
_POINT_KEYS = frozenset(
    {"n_probe", "r0", "prune_margin", "refine", "rescore_factor", "block_q", "sketch_factor"}
)


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Fault-tolerance policy for :class:`RetrievalEngine`.

    ``ladder`` is a sequence of operating-point override dicts (cheapest
    last); under deadline pressure or repeated host-fetch failure the
    engine steps down one rung at a time, and past the last rung (or when a
    batch's fetch exhausts its retries) answers compressed-only with
    ``degraded=True``. ``deadline_s`` is the per-request answer deadline
    driving the rung controller and ``n_deadline_misses``. ``max_queue``
    enables admission control (:class:`Shed`). Backoff jitter is seeded.
    """

    ladder: tuple = ()
    deadline_s: Optional[float] = None
    degrade_age_fraction: float = 0.5
    recover_age_fraction: float = 0.25
    fetch_retries: int = 2
    fetch_backoff_s: float = 0.002
    fetch_backoff_mult: float = 2.0
    max_queue: Optional[int] = None
    seed: int = 0


# Searchable knobs each backend accepts; anything else raises. The port has
# no ``use_fused`` or ``block_c`` (``kernels.ops`` dispatches by device).
_BACKEND_KWARGS: dict[str, frozenset[str]] = {
    "lider": frozenset({
        "n_probe", "r0", "refine", "prune_margin", "rescore_factor", "block_q",
        "sketch_factor",
    }),
    "flat": frozenset(),
    "pq": frozenset(),
    "ivfpq": frozenset({"n_probe"}),
    "sklsh": frozenset(),
    "mplsh": frozenset({"n_probe"}),
}


def make_backend(
    kind: str, index, embs=None, *, updatable: bool = False, device=None, **kw
) -> Callable:
    """Uniform search closure over an index.

    ``device`` places the flat backend's table (``embs``): None means the
    card, and raises when there is none (``device.resolve_device``); every
    other backend searches where its index lives (SK-LSH and MP-LSH score
    their candidates against ``embs``, copied there).

    ``updatable=True`` (LIDER only) returns ``search(params, q, k)`` instead
    of closing over the index: pass the params to ``RetrievalEngine`` so
    ``apply_updates`` can swap them between batches. Such a backend also
    carries the staged spelling of the same search (``host_stage1``,
    ``host_fetch``, ``host_stage2``) that the engine pipelines on host-tier
    params. A backend's ``device`` attribute, where set, is where the engine
    puts its query batches.
    """
    if kind not in _BACKEND_KWARGS:
        raise ValueError(f"unknown backend {kind!r}; expected one of {sorted(_BACKEND_KWARGS)}")
    unknown = set(kw) - _BACKEND_KWARGS[kind]
    if unknown:
        allowed = sorted(_BACKEND_KWARGS[kind]) or "none"
        raise TypeError(
            f"backend {kind!r} got unexpected kwargs {sorted(unknown)}; allowed: {allowed}"
        )
    if updatable and kind != "lider":
        raise ValueError(f"updatable backends require kind='lider', got {kind!r}")
    if kind == "flat":
        table = torch.as_tensor(embs, dtype=torch.float32, device=resolve_device(device))

        def search(q, k):
            return flat_search(table, q, k=k)

        search.device = table.device
        return search
    if kind != "lider":
        n_probe = kw.get("n_probe", 8)
        if kind == "pq":
            search = lambda q, k: pq_search(index, q, k=k)
        elif kind == "ivfpq":
            search = lambda q, k: ivfpq_search(index, q, k=k, n_probe=n_probe)
        else:  # SK-LSH and MP-LSH score candidates against the corpus, kept with the index
            table = torch.as_tensor(embs, dtype=torch.float32, device=index.device)
            if kind == "sklsh":
                search = lambda q, k: sklsh_search(index, table, q, k=k)
            else:
                search = lambda q, k: mplsh_search(index, table, q, k=k, n_probes=n_probe)
        search.device = index.device
        return search

    def _effective(point):
        # A ladder rung overrides the base operating point; the nominal
        # path (point=None) is the base kwargs.
        if not point:
            return kw
        return {**kw, **point}

    def lider_search(params, q, k, point=None):
        # With pruning on, the search also returns the (B, P) mask of
        # routed-but-pruned probes, which the engine folds into its stats.
        eff = _effective(point)
        margin = eff.get("prune_margin")
        return lider_lib.search_lider(
            params, q, k=k,
            n_probe=eff.get("n_probe", 20),
            r0=eff.get("r0", 4),
            refine=eff.get("refine", False),
            prune_margin=margin,
            with_stats=margin is not None,
            rescore_factor=eff.get("rescore_factor", 4),
            block_q=eff.get("block_q"),
            sketch_factor=eff.get("sketch_factor"),
        )

    lider_search.accepts_point = True
    # An explicit block_q in the backend kwargs overrides the engine's
    # online choice.
    lider_search.static_point = kw

    if not updatable:
        def search(q, k, point=None):
            return lider_search(index, q, k, point=point)

        search.accepts_point = True
        search.device = index.device
        return search

    def host_stage1(params, q, k, point=None, stats_out=None):
        """Route + first pass (per-query, or cluster-major with block_q)
        -> ``(prov, pruned or None)``, as ``search_lider`` runs it."""
        eff = _effective(point)
        margin = eff.get("prune_margin")
        block_q = eff.get("block_q")
        # ``stats_out`` (the block_q tuner's hook) applies to the
        # cluster-major pass only: it returns the schedule's sharing and
        # pads it to a fixed worst case.
        stage1_fn = (
            lider_lib.host_first_pass
            if block_q is None
            else partial(lider_lib.host_first_pass_cluster_major, block_q=block_q, stats_out=stats_out)
        )
        prov, pruned = stage1_fn(
            params, q, k=k,
            n_probe=eff.get("n_probe", 20),
            r0=eff.get("r0", 4),
            refine=eff.get("refine", False),
            prune_margin=margin,
            rescore_factor=eff.get("rescore_factor", 4),
            sketch_factor=eff.get("sketch_factor"),
        )
        return prov, (pruned if margin is not None else None)

    def host_stage2(params, fetched, prov_rows, q, k):
        return lider_lib.host_rescore(params.bank.gids, fetched, prov_rows, q, k=k)

    lider_search.host_stage1 = host_stage1
    lider_search.host_fetch = lider_lib.host_fetch
    lider_search.host_stage2 = host_stage2
    return lider_search


# First-pass-dispatched batches the host-tier drain keeps in flight, each
# on its own slot (2 = double buffering, as in the JAX engine).
PIPELINE_DEPTH = 2

# Relative weight of one grouped-kernel step's cluster-tile read vs one
# query slot's work in the block_q cost model: cost(bq) = steps(bq) *
# (DMA_WEIGHT + bq), steps(bq) = sum over clusters of ceil(pairs_c / bq).
DMA_WEIGHT = 4.0


def pick_block_q(counts_list, ladder) -> int:
    """The cheapest ``block_q`` of ``ladder`` for the observed probe
    distribution: ``counts_list`` holds per-batch arrays of (query, probe)
    pairs per probed cluster; the steps each ``block_q`` would have taken
    on that window are ``sum ceil(count / bq)``. Empty window -> first rung.
    """
    counts = [np.asarray(c, np.int64) for c in counts_list if len(c)]
    allc = np.concatenate(counts) if counts else np.zeros((0,), np.int64)
    best_bq, best_cost = ladder[0], float("inf")
    for bq in ladder:
        steps = int(np.sum(-(-allc // bq))) if allc.size else 0
        cost = steps * (DMA_WEIGHT + bq)
        if cost < best_cost:
            best_bq, best_cost = int(bq), cost
    return best_bq


class RetrievalEngine:
    """Batched serving with scheduled admission and AQT accounting.

    With ``params`` set, ``search_fn`` takes ``(params, q, k)`` and the
    engine serves whatever params it holds: ``apply_updates`` swaps them
    between batches, tracking generations, and re-warms only when an update
    changed tensor shapes (capacity growth). ``scheduler`` configures the
    front end (per-tenant fair queues, the result cache, dynamic batch
    sizing, SLO admission); the default is fixed-batch FIFO.
    """

    def __init__(
        self,
        search_fn: Callable,
        *,
        batch_size: int,
        k: int,
        dim: int,
        params=None,
        max_results: int = 65536,
        policy: DegradePolicy | None = None,
        fault_plan=None,
        scheduler: SchedulerConfig | None = None,
        block_q_ladder: tuple | None = None,
    ):
        self.search_fn = search_fn
        self.batch_size = batch_size
        self.k = k
        self.dim = dim
        self.params = params
        if params is not None:
            self.device = params.device
        else:
            # A backend names its device; one that does not runs on the card.
            self.device = resolve_device(getattr(search_fn, "device", None))
        # ``policy`` drives retry/degrade/shed; ``fault_plan`` (a
        # faults.FaultPlan) is active around drain/apply_updates.
        self.policy = policy if policy is not None else DegradePolicy()
        self.fault_plan = fault_plan
        self.rung = 0  # current degradation-ladder rung (0 = nominal)
        self._rng = random.Random(self.policy.seed)  # backoff jitter
        self.generation = 0  # bumped on every apply_updates
        # Device tensors and host-store content change independently; only
        # a change of tensor shapes re-warms the query path.
        self.device_generation = 0  # device tensors changed
        self.host_generation = 0  # host EmbStore content changed
        self.recompiles = 0  # bumped only when shapes changed
        # What warmup ran (its warm_ladder), so that an update can capture
        # the same signatures on new leaves; and how long the last one took.
        self._warm_ladder: bool | None = None
        self.recapture_s = 0.0
        self.sched_cfg = scheduler if scheduler is not None else SchedulerConfig()
        self.scheduler = Scheduler(
            self.sched_cfg,
            batch_size=batch_size,
            deadline_s=self.policy.deadline_s,
            max_queue=self.policy.max_queue,
        )
        self._pipeline_depth = PIPELINE_DEPTH
        cuda = self.device.type == "cuda"
        # The engine's compute stream, used from any thread (_on_stream).
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._slots = [_Slot(self.device, copy_stream) for _ in range(PIPELINE_DEPTH)]
        self._free_slots = list(self._slots)
        # Online block_q tuning (staged host-tier serving only): each
        # dispatch runs the cluster-major first pass at the current choice
        # with the schedule padded to a fixed worst case, and the drained
        # schedule's probe distribution re-picks block_q for the next
        # dispatch. A static block_q in the backend kwargs or a ladder rung
        # overrides it. ``warmup`` runs every choice once.
        self.block_q_ladder = (
            tuple(int(b) for b in block_q_ladder) if block_q_ladder is not None else None
        )
        if self.block_q_ladder is not None and not self.block_q_ladder:
            raise ValueError("block_q_ladder must be non-empty or None")
        self._auto_block_q = self.block_q_ladder[0] if self.block_q_ladder else None
        self._probe_counts: collections.deque = collections.deque(maxlen=32)
        # Bounded FIFO of answers; ``result()`` pops by default, and the
        # bound is the backstop for clients that never collect.
        if max_results < batch_size:
            raise ValueError(
                f"max_results={max_results} must hold at least one batch ({batch_size})"
            )
        self.max_results = max_results
        self.results: collections.OrderedDict[int, object] = collections.OrderedDict()
        # Rids whose answers were evicted by the bound above (itself bounded).
        self._evicted: collections.OrderedDict[int, None] = collections.OrderedDict()
        self.stats = EngineStats()
        self._next_id = 0
        # Padded batch buffer, filled in place for each dispatch.
        self._batch_buf = np.zeros((batch_size, dim), np.float32)

    @property
    def _accepts_point(self) -> bool:
        return getattr(self.search_fn, "accepts_point", False)

    def _rung_point(self) -> dict | None:
        """Operating-point override of the current ladder rung (None at
        rung 0: the nominal path takes no extra kwargs)."""
        ladder = self.policy.ladder
        if self.rung <= 0 or not ladder or not self._accepts_point:
            return None
        raw = ladder[min(self.rung, len(ladder)) - 1]
        return {k: v for k, v in raw.items() if k in _POINT_KEYS}

    def _effective_point(self) -> dict | None:
        """Rung point merged with the tuner's block_q: ladder rung > static
        backend ``block_q`` kwarg > tuned choice."""
        point = self._rung_point()
        auto = self._auto_block_q
        if auto is None:
            return point
        static = getattr(self.search_fn, "static_point", None) or {}
        if static.get("block_q") is not None:
            return point
        merged = {"block_q": auto}
        if point:
            merged.update(point)
        return merged

    def _search(self, q: torch.Tensor):
        point = self._rung_point()
        args = (q, self.k) if self.params is None else (self.params, q, self.k)
        with obs.span("repro_torch.engine.search"):
            if point is not None:
                return self.search_fn(*args, point=point)
            return self.search_fn(*args)

    @staticmethod
    def _split_out(out) -> tuple[TopK, object]:
        """Backends return TopK or (TopK, pruned-probe mask)."""
        if isinstance(out, tuple) and not isinstance(out, TopK):
            return out[0], out[1]
        return out, None

    @contextlib.contextmanager
    def _on_stream(self):
        """Run the body on the engine's stream, whatever the calling
        thread's current stream: it first waits for the caller's stream
        (which made the params and the tables), and the caller's stream
        waits for it afterwards. No-op on the CPU."""
        if self.stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            caller.wait_stream(self.stream)

    @property
    def graph_bytes(self) -> int:
        """Bytes the memory pools of this engine's query-path graphs hold
        (0 on the CPU, where there are no graphs)."""
        return 0 if self.stream is None else graphs.held_bytes(self.stream)

    def _wait(self) -> None:
        """Wait until the device has finished the work given so far (no
        copy to the host)."""
        with obs.span("repro_torch.engine.wait"):
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

    def warmup(self, *, warm_ladder: bool = True):
        """Run every reachable query path once before serving: each batch
        size of the scheduler's ladder, at the nominal point and (with
        ``warm_ladder``) every degradation-ladder rung, and on a host-tier
        index the staged pipeline through every slot at every block_q
        choice. The kernels build on first use and the allocators grow on
        first use; after this, no timed window pays for either. On the card
        this captures every signature of the query path (``core.graphs``),
        so a batch after it replays a graph."""
        self._warm_ladder = warm_ladder
        saved = self.rung
        staged = self._staged_host_serving()
        try:
            with self._on_stream():
                self._warm_all(staged, warm_ladder)
        finally:
            self.rung = saved

    def _warm_all(self, staged: bool, warm_ladder: bool) -> None:
        for bs in self.scheduler.ladder:
            q = torch.zeros((bs, self.dim), dtype=torch.float32, device=self.device)
            rungs = [0]
            if warm_ladder and self.policy.ladder and self._accepts_point:
                rungs += list(range(1, len(self.policy.ladder) + 1))
            for r in rungs:
                self.rung = r
                self._search(q)
                self._wait()
                if staged:
                    self._warm_staged(q)

    def _warm_staged(self, q: torch.Tensor) -> None:
        """The staged spelling of one batch through each slot, at each
        block_q choice, outside any fault plan (its call counters stay
        untouched)."""
        saved_auto = self._auto_block_q
        bqs = list(self.block_q_ladder) if saved_auto is not None else [None]
        try:
            for bq in bqs:
                self._auto_block_q = bq
                extra = {"stats_out": {}} if bq is not None else {}
                for slot in self._slots:
                    prov, _ = self.search_fn.host_stage1(
                        self.params, q, self.k, point=self._effective_point(), **extra
                    )
                    rows = slot.rows_to_host(prov.ids)
                    slot.wait_rows()
                    staging = slot.staging_for(tuple(rows.shape) + (self.dim,))
                    fetched = self.search_fn.host_fetch(self.params, rows, out=staging)
                    self.search_fn.host_stage2(
                        self.params, slot.to_device(fetched), prov.ids, q, self.k
                    )
                    self._wait()
        finally:
            self._auto_block_q = saved_auto

    @property
    def pending_requests(self) -> int:
        """Queued (admitted, not yet executed) request count."""
        return len(self.scheduler)

    def submit(self, query, *, tenant: str = DEFAULT_TENANT) -> int:
        with obs.span("repro_torch.engine.submit"):
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
                # Admission control: refuse now with a structured answer.
                self.stats.n_shed += 1
                self._put_result(rid, Shed(rid=rid, reason=reason))
            return rid

    def apply_updates(self, update_fn: Callable) -> bool:
        """Transactionally swap the served params to ``update_fn(params)``
        between batches.

        ``update_fn`` returns new params or ``(new_params, stats)`` (the
        ``core.update`` convention). Device tensors are replaced, not
        written, but the lifecycle writes a host ``EmbStore`` in place, so
        the store is wrapped in a transaction: if ``update_fn`` raises,
        every host write is rolled back (table, gids and ``version`` bit for
        bit), the engine keeps serving the old generation, and the exception
        propagates. Returns True when tensor shapes changed (capacity
        growth), the one case that re-warms the query path (``recompiles``),
        here and off the query path. An update that makes new device leaves
        of the same shapes adds no signature, but the warmed graphs read the
        old leaves: on the card they are captured again on the new params
        before those are served (``recapture_s``), and the superseded ones
        are freed.
        """
        if self.params is None:
            raise ValueError(
                "engine was not built with params (make_backend(..., "
                "updatable=True) + RetrievalEngine(..., params=...))"
            )
        old_leaves = tensor_leaves(self.params)
        old_store = self._host_store(self.params)
        # The version before the update: the lifecycle writes the store in
        # place, so its identity alone cannot say whether it changed.
        old_hver = None if old_store is None else old_store.version
        txn_store = (
            old_store
            if old_store is not None and old_store.tier == "host" and old_store.rescore is not None
            else None
        )
        if txn_store is not None:
            txn_store.begin_txn()
        try:
            with faults.activate(self.fault_plan), self._on_stream():
                out = update_fn(self.params)
        except Exception:
            if txn_store is not None:
                txn_store.rollback()
            self.stats.n_update_rollbacks += 1
            raise
        if txn_store is not None:
            txn_store.commit()
        new_params = out[0] if isinstance(out, tuple) else out
        new_leaves = tensor_leaves(new_params)
        grew = [tuple(t.shape) for t in old_leaves] != [tuple(t.shape) for t in new_leaves]
        device_changed = grew or any(a is not b for a, b in zip(old_leaves, new_leaves))
        new_store = self._host_store(new_params)
        host_changed = (new_store is not old_store) or (
            new_store is not None and new_store.version != old_hver
        )
        if device_changed and not grew:
            self._recapture(new_params)
        self.params = new_params
        self.generation += 1
        if device_changed:
            self.device_generation += 1
        if host_changed:
            self.host_generation += 1
        # The generation is in every cache key; clearing frees the dead
        # generation's entries from the bound.
        if self.scheduler.cache is not None:
            self.scheduler.cache.clear()
        if grew:
            self.recompiles += 1
            self.warmup()
        if device_changed and self.stream is not None:
            kept = {id(t) for t in new_leaves}
            graphs.release(self.stream, [t for t in old_leaves if id(t) not in kept])
        return grew

    def _recapture(self, new_params) -> None:
        """Run what warmup ran on ``new_params`` (each signature known, so
        each is captured and replayed, not run eagerly first), before they
        are swapped in; nothing on the CPU, which has no graphs."""
        if self.stream is None or self._warm_ladder is None:
            return
        t0 = time.perf_counter()
        served = self.params
        self.params = new_params
        try:
            self.warmup(warm_ladder=self._warm_ladder)
        finally:
            self.params = served
        self.recapture_s = time.perf_counter() - t0

    @staticmethod
    def _host_store(params):
        return getattr(getattr(params, "bank", None), "store", None)

    def _take_batch(self, bs: int) -> list[Request]:
        """Pop up to ``bs`` requests (weighted-fair across tenants),
        answering cache hits inline and topping the batch back up. The
        batch's requests add their wait since submit to ``queue_wait_s``."""
        with obs.span("repro_torch.engine.take"):
            chunk: list[Request] = []
            cache = self.scheduler.cache
            while len(chunk) < bs:
                reqs = self.scheduler.take(bs - len(chunk))
                if not reqs:
                    break
                for req in reqs:
                    hit = (
                        cache.get(req.fp, (self.k, self.generation, self.rung))
                        if cache is not None and req.fp is not None
                        else None
                    )
                    if hit is not None:
                        self._answer_cached(req, hit)
                    else:
                        if cache is not None:
                            self.stats.n_cache_misses += 1
                        chunk.append(req)
            if chunk:
                now = time.perf_counter()
                self.stats.queue_wait_s += sum(now - req.t_submit for req in chunk)
                self.stats.n_queue_waits += len(chunk)
            return chunk

    def _answer_cached(self, req: Request, hit) -> None:
        """Serve ``req`` from the result cache: the same bytes, generation
        and rung as a fresh search, no device time (counts in n_queries,
        adds nothing to total_time_s)."""
        ids, scores = hit
        latency = time.perf_counter() - req.t_submit
        self.stats.n_cache_hits += 1
        self.stats.n_queries += 1
        self.stats.recent_latency_s.append(latency)
        deadline = self.policy.deadline_s
        if deadline is not None and latency > deadline:
            self.stats.n_deadline_misses += 1
        self._put_result(
            req.rid,
            QueryResult(
                ids.copy(),  # clients may mutate; never hand out the cached arrays
                scores.copy(),
                rung=self.rung,
                latency_s=latency,
                cached=True,
                generation=self.generation,
            ),
        )

    def _batch_size(self, n: int) -> int:
        """The smallest warmed batch size that holds ``n`` requests."""
        return next((b for b in self.scheduler.ladder if b >= n), self.scheduler.ladder[-1])

    def _device_batch(self, chunk: list[Request], bs: int, slot: _Slot | None = None) -> torch.Tensor:
        """The padded (bs, dim) batch on the device, a copy of the engine's
        buffer (refilled for the next batch while this one may still be in
        flight); through ``slot``'s pinned buffer when given."""
        with obs.span("repro_torch.engine.stage"):
            q = self._batch_buf[:bs]
            for i, req in enumerate(chunk):
                q[i] = req.query
            if len(chunk) < bs:  # zero stale rows from the last batch
                q[len(chunk):] = 0.0
            if slot is not None:
                return slot.queries_to_device(q)
            return torch.tensor(q, device=self.device)

    def _put_result(self, rid: int, value) -> None:
        """Insert one answer, enforcing the results-map bound."""
        self.results[rid] = value
        while len(self.results) > self.max_results:
            old_rid, _ = self.results.popitem(last=False)  # evict oldest
            self.stats.n_results_evicted += 1
            self._evicted[old_rid] = None
            while len(self._evicted) > self.max_results:
                self._evicted.popitem(last=False)

    def _record_batch(
        self, chunk, n, out, pruned, *, bs=None, rung=None, degraded=False, t_dispatch=None,
    ) -> None:
        """Account one completed batch and route its answers, outside the
        AQT window: this includes the results' copy to the host.

        ``bs``/``rung`` are what the batch was dispatched with (the
        pipelined drain may step the live rung before it completes)."""
        with obs.span("repro_torch.engine.record"):
            bs = self.batch_size if bs is None else bs
            rung = self.rung if rung is None else rung
            faults.fire(faults.D2H)  # "delay" here models a slow device-to-host copy
            ids = _numpy(out.ids)
            scores = _numpy(out.scores)
            self.stats.n_queries += n
            self.stats.n_batches += 1
            self.stats.n_padded += bs - n
            self.stats.batch_size_trace.append(bs)
            if degraded:
                self.stats.n_degraded += n
            if pruned is not None:
                # Only the n real queries count; padded rows route too.
                pmask = _numpy(pruned)[:n]
                self.stats.n_probes_total += int(pmask.size)
                self.stats.n_probes_pruned += int(pmask.sum())
                self.stats.batch_pruned_fraction.append(float(pmask.sum()) / max(pmask.size, 1))
            now = time.perf_counter()
            if t_dispatch is not None:
                self.stats.batch_latency_s.append(now - t_dispatch)
            deadline = self.policy.deadline_s
            cache = self.scheduler.cache
            for i, req in enumerate(chunk):
                latency = now - req.t_submit
                self.stats.recent_latency_s.append(latency)
                if deadline is not None and latency > deadline:
                    self.stats.n_deadline_misses += 1
                self._put_result(
                    req.rid,
                    QueryResult(
                        ids[i], scores[i], degraded=degraded, rung=rung,
                        latency_s=latency, generation=self.generation,
                    ),
                )
                # Only full-fidelity answers are cacheable.
                if cache is not None and req.fp is not None and not degraded:
                    cache.put(req.fp, (self.k, self.generation, rung), ids[i], scores[i])

    def _staged_host_serving(self) -> bool:
        """Host-tier LIDER params and a backend with the staged search."""
        return (
            self.params is not None
            and getattr(self.search_fn, "host_stage1", None) is not None
            and getattr(getattr(self.params, "bank", None), "rescore_tier", "device") == "host"
        )

    def _adjust_rung(self) -> None:
        """Operating-point controller, once per dispatch.

        Without a scheduler SLO: deadline-pressure hysteresis, one rung
        down when the oldest queued request has aged past
        ``degrade_age_fraction`` of the deadline, one up below
        ``recover_age_fraction``. With ``SchedulerConfig.slo_s``: the
        scheduler's load signal maps onto the ladder, rung = round(load *
        len). Every rung was run in warmup."""
        pol = self.policy
        if not pol.ladder or not self._accepts_point:
            return
        if self.sched_cfg.slo_s is not None:
            load = self.scheduler.load_signal(time.perf_counter())
            target = min(int(round(load * len(pol.ladder))), len(pol.ladder))
            if target > self.rung:
                self.stats.n_rung_steps += target - self.rung
            self.rung = target
            return
        if pol.deadline_s is None:
            return
        oldest = self.scheduler.oldest_submit()
        if oldest is None:
            if self.rung > 0:
                self.rung -= 1
            return
        age = time.perf_counter() - oldest
        if age >= pol.deadline_s * pol.degrade_age_fraction:
            if self.rung < len(pol.ladder):
                self.rung += 1
                self.stats.n_rung_steps += 1
        elif age <= pol.deadline_s * pol.recover_age_fraction and self.rung > 0:
            self.rung -= 1

    def drain(self, max_dispatches: int | None = None) -> None:
        """Execute queued requests in scheduler-sized batches.

        Host-tier LIDER params drain through the pipelined fetch -> rescore
        path (:meth:`_drain_pipelined`); everything else runs serially
        (:meth:`_execute_batch`). ``max_dispatches`` bounds the batches run
        by this call (the open-loop driver's hook). The engine's fault plan
        is active for the duration.
        """
        with faults.activate(self.fault_plan), self._on_stream():
            if self._staged_host_serving():
                return self._drain_pipelined(max_dispatches)
            n_disp = 0
            while len(self.scheduler):
                if max_dispatches is not None and n_disp >= max_dispatches:
                    break
                self._adjust_rung()
                chunk = self._take_batch(self.scheduler.pick_batch_size())
                if not chunk:  # everything was answered from the cache
                    continue
                n_disp += 1
                self._execute_batch(chunk)

    def execute_chunk(self, chunk: list[Request]) -> list:
        """Synchronously execute one already-admitted batch and return its
        answers in request order (popped from the results map): the
        dispatch primitive of a replica router, which owns admission and
        batching itself. The engine's fault plan is active meanwhile."""
        with faults.activate(self.fault_plan), self._on_stream():
            if self._staged_host_serving():
                t0 = time.perf_counter()
                e = self._dispatch_stage1(chunk)
                while True:
                    if e.retry_at is not None:
                        wait = e.retry_at - time.perf_counter()
                        if wait > 0:
                            time.sleep(wait)
                    d2h_s = self._finish_host_batch(e)
                    if d2h_s is not None:
                        break
                self.stats.total_time_s += max(time.perf_counter() - t0 - d2h_s, 0.0)
            else:
                self._execute_batch(chunk)
        return [self.results.pop(r.rid) for r in chunk]

    def _execute_batch(self, chunk: list[Request]) -> None:
        """The serial execution core: pad to the smallest warmed batch
        size, search, wait for the device, account. The AQT window closes
        before the results' copy to the host."""
        bs = self._batch_size(len(chunk))
        q = self._device_batch(chunk, bs)
        t0 = time.perf_counter()
        out, pruned = self._split_out(self._search(q))
        self._wait()
        dt = time.perf_counter() - t0
        self.stats.total_time_s += dt
        self.scheduler.observe_service(bs, dt)
        self._record_batch(chunk, len(chunk), out, pruned, bs=bs, t_dispatch=t0)

    def _drain_pipelined(self, max_dispatches: int | None = None) -> None:
        """Pipelined host-tier drain.

        Batch i+1's first pass is dispatched to the device before batch
        i's provisional rows are read on the host and its exact rows
        gathered, so the gather and the copy of the rows to the card hide
        behind device work for every batch but the last. The AQT window
        spans the whole drain (per-batch windows would count the overlap
        twice) and excludes the results' copies to the host, which are
        measured and subtracted.

        A batch whose host fetch fails is parked with a ``retry_at``
        backoff stamp while other pending batches keep fetching and new
        first passes keep dispatching; the engine sleeps only when every
        pending batch is backing off and nothing else can run.
        """
        t0 = time.perf_counter()
        d2h_s = 0.0
        pending: collections.deque[_PendingBatch] = collections.deque()
        n_disp = 0
        while len(self.scheduler) or pending:
            may_dispatch = (
                len(self.scheduler)
                and len(pending) < self._pipeline_depth
                and (max_dispatches is None or n_disp < max_dispatches)
            )
            if may_dispatch:
                self._adjust_rung()
                chunk = self._take_batch(self.scheduler.pick_batch_size())
                if chunk:
                    # The first pass returns before the device finishes, so
                    # each pending batch's fetch below overlaps it.
                    nxt = self._dispatch_stage1(chunk)
                    for e in pending:
                        e.overlap_armed = True
                        e.next_slot = e.next_slot or nxt.slot
                    pending.append(nxt)
                    n_disp += 1
                continue
            if not pending:
                break  # queue non-empty but dispatch budget exhausted
            now = time.perf_counter()
            entry = next((e for e in pending if e.retry_at is None or e.retry_at <= now), None)
            if entry is None:
                # Every pending batch is backing off and the dispatch
                # window is closed: sleep to the earliest retry stamp.
                wait = min(e.retry_at for e in pending) - now
                if wait > 0:
                    time.sleep(wait)
                continue
            finished_d2h = self._finish_host_batch(entry)
            if finished_d2h is not None:
                pending.remove(entry)
                d2h_s += finished_d2h
        self.stats.total_time_s += max(time.perf_counter() - t0 - d2h_s, 0.0)

    def _dispatch_stage1(self, chunk: list[Request]) -> _PendingBatch:
        """Pad, dispatch the first pass and start the copy of its
        provisional rows to the host, on a free slot. The rung is captured
        so the answers are recorded against the point that computed them."""
        bs = self._batch_size(len(chunk))
        slot = self._free_slots.pop()
        q = self._device_batch(chunk, bs, slot)
        t0 = time.perf_counter()
        stats_out = {} if self._auto_block_q is not None else None
        with obs.span("repro_torch.engine.search"):
            if stats_out is not None:
                prov, pruned = self.search_fn.host_stage1(
                    self.params, q, self.k, point=self._effective_point(), stats_out=stats_out,
                )
            else:
                prov, pruned = self.search_fn.host_stage1(
                    self.params, q, self.k, point=self._rung_point()
                )
        rows = slot.rows_to_host(prov.ids)
        self.scheduler.observe_service(bs, time.perf_counter() - t0)
        if stats_out:
            # The schedule's measured sharing, and block_q re-picked for the
            # next dispatch from the window of probe distributions.
            self.stats.n_sched_pairs += stats_out["n_pairs"]
            self.stats.n_sched_steps += stats_out["n_steps"]
            self._probe_counts.append(stats_out["cluster_counts"])
            self._auto_block_q = pick_block_q(self._probe_counts, self.block_q_ladder)
        return _PendingBatch(
            chunk=chunk, bs=bs, q=q, prov=prov, pruned=pruned, rung=self.rung,
            slot=slot, rows=rows, t_dispatch=t0,
        )

    def _finish_host_batch(self, e: _PendingBatch) -> float | None:
        """Fetch + rescore one dispatched batch. Returns the seconds of the
        results' copy to the host (outside the AQT window), or None when
        the fetch failed and the batch was parked for a backoff retry.

        A fetch that exhausts its retries does not abort the drain: the
        batch is answered compressed-only from its provisional top-k'
        (``degraded=True``) and the rung controller steps down one rung.
        Backoff is exponential with seeded jitter."""
        pol = self.policy
        if not e.blocked:
            # Wait for the rows' copy before the fetch timer starts, so the
            # fetch stat does not include the first pass's device time.
            e.slot.wait_rows()
            e.blocked = True
        staging = e.slot.staging_for(tuple(e.rows.shape) + (self.dim,))
        under_device_work = e.next_slot is not None and e.next_slot.stage1_running()
        try:
            tf0 = time.perf_counter()
            fetched = self.search_fn.host_fetch(self.params, e.rows, out=staging)
            self.stats.host_fetch_us += (time.perf_counter() - tf0) * 1e6
        except Exception:  # a failed host fetch degrades this batch only
            e.attempts += 1
            if e.attempts > pol.fetch_retries:
                self.stats.n_fetch_failures += 1
                return self._record_degraded(e)
            self.stats.n_fetch_retries += 1
            delay = pol.fetch_backoff_s * (pol.fetch_backoff_mult ** (e.attempts - 1))
            delay *= 1.0 + self._rng.random()
            e.retry_at = time.perf_counter() + delay
            return None  # parked; the drain loop keeps other batches moving
        self.stats.n_host_fetches += 1
        self.stats.host_fetch_bytes += fetched.numel() * fetched.element_size()
        if e.overlap_armed:
            self.stats.n_overlapped_fetches += 1
        if under_device_work:
            self.stats.n_fetches_under_device_work += 1
        out = self.search_fn.host_stage2(
            self.params, e.slot.to_device(fetched), e.prov.ids, e.q, self.k
        )
        self._wait()
        self.stats.h2d_s += e.slot.copy_seconds()
        return self._complete(e, out, degraded=False)

    def _record_degraded(self, e: _PendingBatch) -> float:
        """Answer a fetch-exhausted batch compressed-only: stage 1 already
        holds the code-domain top-k' (no fetch, no exact rescore)."""
        if self.policy.ladder and self.rung < len(self.policy.ladder):
            self.rung += 1
            self.stats.n_rung_steps += 1
        out = lider_lib.compressed_only_topk(self.params.bank.gids, e.prov, k=self.k)
        self._wait()
        return self._complete(e, out, degraded=True)

    def _complete(self, e: _PendingBatch, out: TopK, *, degraded: bool) -> float:
        """Record a finished pipelined batch, free its slot, and return the
        seconds the recording (the results' copy to the host) took."""
        tc0 = time.perf_counter()
        self._record_batch(
            e.chunk, len(e.chunk), out, e.pruned, bs=e.bs, rung=e.rung,
            degraded=degraded, t_dispatch=e.t_dispatch,
        )
        self._free_slots.append(e.slot)
        return time.perf_counter() - tc0

    def result(self, rid: int, *, keep: bool = False):
        """Fetch (and by default release) the answer for ``rid``: a
        :class:`QueryResult` (unpacks as ``(ids, scores)``), a :class:`Shed`
        for refused requests, :data:`EVICTED` when the answer was evicted by
        the ``max_results`` bound, or ``None`` for never-submitted or
        already-collected ids. ``keep=True`` leaves it in the map."""
        out = self.results.get(rid) if keep else self.results.pop(rid, None)
        if out is not None:
            return out
        if rid in self._evicted:
            return EVICTED
        return None
