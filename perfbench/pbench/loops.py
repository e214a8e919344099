"""The two ways the harness offers load: a closed loop of whole batches,
and an open loop of timed arrivals through the serving engine.

Both stamp times with the host clock relative to the window's start, and
keep the answers of a seeded sample of requests for the check.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.profiler import record_function


def closed_loop(search, pool: torch.Tensor, seconds: float, *, k: int, in_flight: int,
                keep_rows, stretch=None, trace_from: int = 0, trace_batches: int = 0) -> dict:
    """Dispatch batches of ``pool`` (nb, B, d) in turn, ``in_flight`` at a
    time, until ``seconds`` have passed; then wait for the last answer.

    The next batch is dispatched before the oldest one's ids and scores are
    copied to the host (on a stream of their own, into pinned buffers).
    ``keep_rows(j)`` names the rows of batch ``j`` whose answers are kept.
    With a ``stretch``, batches ``trace_from`` to ``trace_from +
    trace_batches`` run profiled, with nothing else in flight around them.
    """
    dev = pool.device
    cuda = dev.type == "cuda"
    nb, b = pool.shape[:2]
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    bufs = [(torch.empty((b, k), dtype=torch.int32, pin_memory=cuda),
             torch.empty((b, k), dtype=torch.float32, pin_memory=cuda)) for _ in range(in_flight)]
    pending: collections.deque = collections.deque()
    kept, host_s, traced = [], [], []
    n_done = 0

    def finish() -> None:
        nonlocal n_done
        j, out, ev = pending.popleft()
        ids_h, sc_h = bufs[j % in_flight]
        with record_function("pbench.answer"):
            if cuda:
                with torch.cuda.stream(copy_stream):
                    copy_stream.wait_event(ev)
                    ids_h.copy_(out.ids, non_blocking=True)
                    sc_h.copy_(out.scores, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(copy_stream)
                done.synchronize()
            else:
                ids_h.copy_(out.ids)
                sc_h.copy_(out.scores)
        rows = keep_rows(j)
        kept.append((j, rows, ids_h[rows].clone(), sc_h[rows].clone()))
        n_done += b

    t0 = time.perf_counter()
    i = 0
    tracing = False
    while True:
        if stretch is not None and not tracing and i == trace_from:
            while pending:
                finish()
            stretch.begin()
            tracing = True
        if time.perf_counter() - t0 < seconds:
            with record_function("pbench.dispatch"):
                h0 = time.perf_counter()
                out = search(pool[i % nb])
                host_s.append(time.perf_counter() - h0)
                ev = torch.cuda.Event() if cuda else None
                if cuda:
                    ev.record()
            pending.append((i, out, ev))
            if tracing:
                traced.append(i)
            i += 1
        elif not pending:
            break
        while len(pending) >= in_flight or (pending and time.perf_counter() - t0 >= seconds):
            finish()
        if tracing and (len(traced) >= trace_batches or time.perf_counter() - t0 >= seconds):
            while pending:
                finish()
            stretch.end()
            stretch, tracing = None, False
    t_last = time.perf_counter() - t0
    return {"n_batches": i, "n_queries": n_done, "window_s": t_last, "host_s": host_s,
            "traced": traced, "kept": kept}


def open_loop(engine, pool: np.ndarray, times: np.ndarray, qidx: np.ndarray, tenants: list[str],
              *, keep: set, answer_of, stretch=None, trace_from_s: float | None = None) -> dict:
    """Submit request ``i`` (pool row ``qidx[i]``) once ``times[i]`` seconds
    of the window have passed, and drain the engine a batch at a time in
    between; after the last arrival, drain until every request is answered.

    ``answer_of(result)`` gives a result's ``(ids, scores)``, or None for a
    refusal. With a ``stretch``, the profiler records from ``trace_from_s``
    to the last answer."""
    n = times.shape[0]
    submit = np.full(n, np.nan)
    dispatch = np.full(n, np.nan)
    answer = np.full(n, np.nan)
    kept, refused, drains = {}, 0, []
    base = None
    t0 = time.perf_counter()
    i = 0
    while i < n or engine.pending_requests:
        now = time.perf_counter() - t0
        if stretch is not None and trace_from_s is not None and now >= trace_from_s:
            stretch.begin()
            trace_from_s = None
        if i < n and times[i] <= now:
            with record_function("pbench.submit"):
                while i < n and times[i] <= now:
                    rid = engine.submit(pool[qidx[i]], tenant=tenants[i])
                    base = rid - i if base is None else base
                    submit[i] = now
                    i += 1
                    now = time.perf_counter() - t0
        if engine.pending_requests:
            td = time.perf_counter() - t0
            with record_function("pbench.drain"):
                engine.drain(max_dispatches=1)
            ta = time.perf_counter() - t0
            drains.append(ta - td)
            while engine.results:
                rid, res = engine.results.popitem(last=False)
                j = rid - base
                dispatch[j], answer[j] = td, ta
                got = answer_of(res)
                if got is None:
                    refused += 1
                elif j in keep:
                    kept[j] = got
        elif i < n:
            wait = times[i] - (time.perf_counter() - t0)
            if wait > 0:
                with record_function("pbench.wait"):
                    time.sleep(min(wait, 1e-3))
    if stretch is not None and trace_from_s is None:
        stretch.end()
    return {"n_requests": n, "submit": submit, "dispatch": dispatch, "answer": answer,
            "due": times, "qidx": qidx, "kept": kept, "refused": refused,
            "drain_s": drains, "window_s": time.perf_counter() - t0}
