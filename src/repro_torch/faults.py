"""Deterministic, seedable fault injection for the serving stack.

The port's own copy of the JAX package's ``repro/faults.py`` (pure
Python), so that the port imports nothing of that package. In the port
only ``checkpoint_write`` fires so far (``training.checkpoint.save_index``).

A :class:`FaultPlan` is a schedule of :class:`FaultSpec` entries, each bound
to a named injection *site*.  Production code calls :func:`fire` at each
site; when no plan is active this is a single ``None`` check (zero cost).
When a plan is active, ``fire`` consults the plan deterministically — per-site
invocation counters plus a per-site seeded RNG — so the same plan replays the
same schedule regardless of wall-clock time or interleaving across sites.

Sites used by the repo:

================  ===========================================================
``host_fetch``    ``EmbStore.fetch`` — host gather for the rescore stage.
                  Modes: ``error`` (raise), ``delay`` (latency spike).
``host_write``    ``EmbStore.write_rows`` — fires *after* the in-place host
                  mutation, modelling an ``update_fn`` crash mid-update.
``checkpoint_write``  ``checkpoint.save`` / ``save_index`` — ``truncate``
                  corrupts a leaf file before the atomic rename;
                  ``torn_write`` additionally crashes inside the
                  ``index.old`` swap window.
``shard_search``  ``make_sharded_search`` wrapper — ``kill_shard`` marks
                  shards dead in the health mask (payload ``{"shard": i}``
                  or ``{"shards": [...]}``).
``d2h``           engine result recording — ``delay`` models a slow
                  ``__array__`` device-to-host copy.
``replica_dispatch``  ``QueryRouter`` batch dispatch onto one replica —
                  ``error``/``delay`` hit whichever replica the matching
                  call lands on; ``straggle`` (sleep) and ``fail`` (raise)
                  target one replica via payload ``{"replica": name}``.
``replica_heartbeat``  replica health probe — ``error`` is a missed
                  heartbeat (drives suspect/dead transitions).
``replica_kill``  fired once per router drain — ``kill_replica`` with
                  payload ``{"replica": name}`` hard-kills that replica:
                  in-flight batches fail over, it never rejoins routing.
================  ===========================================================

Fault modes ``error`` and ``delay`` are handled generically inside
:func:`fire` (raise :class:`InjectedFault` / ``time.sleep``).  Any other
mode is site-specific: ``fire`` returns the matching spec and the call site
interprets it.

The router dispatches batches from worker threads, so scheduling state
(per-site counters, per-site RNGs, fired log) is guarded by a lock; the
generic sleep/raise happen *outside* it, so one replica's injected
straggle never serializes another replica's dispatch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import random
import threading
import time
from typing import Any, Optional, Tuple

# Canonical site names (import these rather than retyping strings).
HOST_FETCH = "host_fetch"
HOST_WRITE = "host_write"
CHECKPOINT_WRITE = "checkpoint_write"
SHARD_SEARCH = "shard_search"
D2H = "d2h"
REPLICA_DISPATCH = "replica_dispatch"
REPLICA_HEARTBEAT = "replica_heartbeat"
REPLICA_KILL = "replica_kill"

SITES = (
    HOST_FETCH,
    HOST_WRITE,
    CHECKPOINT_WRITE,
    SHARD_SEARCH,
    D2H,
    REPLICA_DISPATCH,
    REPLICA_HEARTBEAT,
    REPLICA_KILL,
)


class InjectedFault(RuntimeError):
    """Raised by ``mode="error"`` faults (and ``torn_write`` crashes)."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fault at site {site!r}")
        self.site = site


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault at one site.

    ``times`` selects specific 0-based per-site invocation indices; when
    ``None``, ``probability`` draws from the plan's per-site RNG instead.
    ``count`` caps the total number of firings of this spec.  ``delay_s``
    applies to ``mode="delay"``; ``payload`` carries site-specific data
    (e.g. which shard to kill, which checkpoint leaf to truncate).
    """

    site: str
    mode: str = "error"
    times: Optional[Tuple[int, ...]] = None
    probability: float = 0.0
    count: Optional[int] = None
    delay_s: float = 0.0
    payload: Any = None

    def to_dict(self) -> dict:
        d = {"site": self.site, "mode": self.mode}
        if self.times is not None:
            d["times"] = list(self.times)
        if self.probability:
            d["probability"] = self.probability
        if self.count is not None:
            d["count"] = self.count
        if self.delay_s:
            d["delay_s"] = self.delay_s
        if self.payload is not None:
            d["payload"] = self.payload
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        times = d.get("times")
        return cls(
            site=d["site"],
            mode=d.get("mode", "error"),
            times=None if times is None else tuple(int(t) for t in times),
            probability=float(d.get("probability", 0.0)),
            count=d.get("count"),
            delay_s=float(d.get("delay_s", 0.0)),
            payload=d.get("payload"),
        )


class FaultPlan:
    """A deterministic schedule of faults across sites.

    The plan keeps one invocation counter and one seeded RNG per site, so
    probabilistic faults replay identically for a given seed no matter how
    calls to different sites interleave.  ``fired`` records every firing as
    ``(site, call_index, mode)`` for post-hoc assertions.
    """

    def __init__(self, specs=(), *, seed: int = 0):
        self.seed = int(seed)
        self.specs = tuple(
            s if isinstance(s, FaultSpec) else FaultSpec.from_dict(s) for s in specs
        )
        self._calls: dict = {}
        self._rngs: dict = {}
        self._n_fired_by_spec = [0] * len(self.specs)
        self.fired: list = []
        # The router fires sites from dispatch worker threads; the lock
        # keeps counter/RNG/log state consistent. Generic sleep/raise run
        # outside it (see fire) so injected delays never serialize sites.
        self._lock = threading.Lock()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_json(cls, source) -> "FaultPlan":
        """Build from a dict, a JSON string, or a path to a JSON file.

        Format: ``{"seed": 0, "faults": [{"site": ..., "mode": ..., ...}]}``.
        """
        if isinstance(source, dict):
            obj = source
        else:
            text = str(source)
            if text.lstrip().startswith("{"):
                obj = json.loads(text)
            else:
                with open(text) as f:
                    obj = json.load(f)
        return cls(obj.get("faults", ()), seed=obj.get("seed", 0))

    def to_json(self) -> dict:
        return {"seed": self.seed, "faults": [s.to_dict() for s in self.specs]}

    # -- scheduling --------------------------------------------------------
    def _rng_for(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def fire(self, site: str):
        """Advance the site counter; raise/sleep/return per matching spec.

        Returns the first matching spec whose mode is *not* handled
        generically (for the call site to interpret), else ``None``.
        """
        pending = None
        delay_s = 0.0
        err = None
        with self._lock:
            idx = self._calls.get(site, 0)
            self._calls[site] = idx + 1
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if (
                    spec.count is not None
                    and self._n_fired_by_spec[i] >= spec.count
                ):
                    continue
                if spec.times is not None:
                    hit = idx in spec.times
                elif spec.probability > 0.0:
                    hit = self._rng_for(site).random() < spec.probability
                else:
                    hit = False
                if not hit:
                    continue
                self._n_fired_by_spec[i] += 1
                self.fired.append((site, idx, spec.mode))
                if spec.mode == "delay":
                    delay_s += spec.delay_s
                elif spec.mode == "error":
                    if err is None:
                        err = InjectedFault(
                            site, f"injected {site} fault (call {idx})"
                        )
                elif pending is None:
                    pending = spec
        if delay_s > 0.0:
            time.sleep(delay_s)
        if err is not None:
            raise err
        return pending

    @property
    def n_fired(self) -> int:
        return len(self.fired)

    def site_counts(self) -> dict:
        """Firings per site, zero-filled over every *configured* site.

        Covers the union of the canonical :data:`SITES` and any site named
        by a spec — a site that never fired reports 0 rather than being
        omitted, so chaos CI stats diffs are stable run-to-run.
        """
        with self._lock:
            counts = {site: 0 for site in SITES}
            for spec in self.specs:
                counts.setdefault(spec.site, 0)
            for site, _idx, _mode in self.fired:
                counts[site] = counts.get(site, 0) + 1
        return counts


def spec_targets(spec: Optional[FaultSpec], name: str) -> bool:
    """Does a site-specific spec target replica/shard ``name``?

    A spec with no payload (or no ``replica`` key) targets everything;
    payload ``{"replica": <name>}`` targets exactly that replica. The
    router uses this to interpret ``straggle``/``fail``/``kill_replica``
    specs returned by :func:`fire`.
    """
    if spec is None:
        return False
    payload = spec.payload
    if not isinstance(payload, dict) or "replica" not in payload:
        return True
    return payload["replica"] == name


# ---------------------------------------------------------------------------
# Module-global activation.  Call sites use the module-level ``fire`` which
# is a no-op (one ``None`` check) unless a plan is active.
# ---------------------------------------------------------------------------
_ACTIVE: Optional[FaultPlan] = None


def set_plan(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` globally (``None`` disables injection)."""
    global _ACTIVE
    _ACTIVE = plan


def get_plan() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def activate(plan: Optional[FaultPlan]):
    """Scoped activation; no-op when ``plan`` is None (keeps any global plan)."""
    global _ACTIVE
    if plan is None:
        yield None
        return
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def fire(site: str):
    """Zero-cost hook: forwards to the active plan, if any."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.fire(site)
