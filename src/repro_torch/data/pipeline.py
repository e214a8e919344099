"""Step-indexed data pipeline: deterministic, skippable, checkpointable
(the port's copy of the JAX package's ``data/pipeline.py``, which imports
no JAX).

The pipeline is a pure function of (seed, step) plus a host-side prefetch
queue. Its checkpoint state is a single integer; restoring a run replays the
exact batch stream (fault_tolerance contract) and a replacement node at any
step sees the same data as the node it replaced.
"""
from __future__ import annotations

import threading
import queue
from typing import Callable, Iterator


class DataPipeline:
    """Wraps ``batch_at(step) -> batch`` into a prefetching iterator."""

    def __init__(
        self,
        batch_at: Callable[[int], dict],
        *,
        start_step: int = 0,
        prefetch: int = 2,
    ):
        self.batch_at = batch_at
        self.step = start_step
        self.prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        if prefetch > 0:
            self._start_worker()

    # -- checkpointable state ------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_state(cls, batch_at, state: dict, **kw) -> "DataPipeline":
        return cls(batch_at, start_step=state["step"], **kw)

    # -- iteration -----------------------------------------------------------
    def _start_worker(self):
        def work():
            s = self.step
            while not self._stop.is_set():
                try:
                    self._q.put((s, self.batch_at(s)), timeout=0.1)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self.prefetch > 0:
            while True:
                s, batch = self._q.get()
                if s == self.step:  # drop stale prefetches after a restore
                    break
        else:
            batch = self.batch_at(self.step)
        self.step += 1
        return batch

    def close(self):
        self._stop.set()
