"""Serving: the batched retrieval engine, its scheduler, open-loop
traffic, and the replica fabric (replica set, health-checked router,
rolling updates)."""
from .engine import (
    EVICTED,
    DegradePolicy,
    EngineStats,
    QueryResult,
    RetrievalEngine,
    Shed,
    make_backend,
    pick_block_q,
)
from .replica import (
    DEAD,
    HEALTHY,
    RECOVERING,
    SUSPECT,
    HealthPolicy,
    Replica,
    ReplicaDead,
    ReplicaSet,
    clone_params,
)
from .router import QueryRouter, RouterConfig, RouterControl, RouterStats
from .scheduler import (
    DEFAULT_TENANT,
    Request,
    ResultCache,
    Scheduler,
    SchedulerConfig,
    batch_ladder,
)
from .traffic import make_trace, run_open_loop, zipf_weights

__all__ = [
    "DEAD",
    "DEFAULT_TENANT",
    "DegradePolicy",
    "EVICTED",
    "EngineStats",
    "HEALTHY",
    "HealthPolicy",
    "QueryResult",
    "QueryRouter",
    "RECOVERING",
    "Replica",
    "ReplicaDead",
    "ReplicaSet",
    "Request",
    "ResultCache",
    "RetrievalEngine",
    "RouterConfig",
    "RouterControl",
    "RouterStats",
    "SUSPECT",
    "Scheduler",
    "SchedulerConfig",
    "Shed",
    "batch_ladder",
    "clone_params",
    "make_backend",
    "make_trace",
    "pick_block_q",
    "run_open_loop",
    "zipf_weights",
]
