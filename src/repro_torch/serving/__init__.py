"""Serving: the batched retrieval engine, its scheduler and open-loop
traffic. The replica fabric and router are a later slice."""
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
    "DEFAULT_TENANT",
    "DegradePolicy",
    "EVICTED",
    "EngineStats",
    "QueryResult",
    "Request",
    "ResultCache",
    "RetrievalEngine",
    "Scheduler",
    "SchedulerConfig",
    "Shed",
    "batch_ladder",
    "make_backend",
    "make_trace",
    "pick_block_q",
    "run_open_loop",
    "zipf_weights",
]
