"""The open loop times a request from when it was due: a stall of the
engine delays the requests that fall due during it, and ``p95_ms`` sees
that; a latency taken from the submit time would not."""
import collections
import importlib.util

import numpy as np

from pbench import data, loops
from perfbench_tiny import BENCH


class Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += s


class FakeEngine:
    """Answers up to ``batch`` queued requests a drain, each drain taking
    ``service`` seconds of the fake clock, one of them ``stall`` more."""

    def __init__(self, clock, *, batch=32, service=0.002, stall_at=None, stall=0.0):
        self.clock, self.batch, self.service = clock, batch, service
        self.stall_at, self.stall = stall_at, stall
        self.queue, self.next_id, self.drains = [], 0, 0
        self.results = collections.OrderedDict()
        self.submitted = {}

    @property
    def pending_requests(self):
        return len(self.queue)

    def submit(self, query, tenant=None):
        rid = self.next_id
        self.next_id += 1
        self.queue.append(rid)
        self.submitted[rid] = self.clock.t
        return rid

    def drain(self, max_dispatches=None):
        take, self.queue = self.queue[:self.batch], self.queue[self.batch:]
        self.clock.t += self.service
        if self.stall_at is not None and self.drains == self.stall_at:
            self.clock.t += self.stall
        self.drains += 1
        for rid in take:
            self.results[rid] = ("ids", "scores")


def _p95(win):
    spec = importlib.util.spec_from_file_location("p95", BENCH / "metrics" / "p95_ms.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read({"closed": False, "window": win})


def _run(monkeypatch, **kw):
    clock = Clock()
    monkeypatch.setattr(loops.time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(loops.time, "sleep", clock.sleep)
    times, qidx, _ = data.make_trace(seed=5, n_arrivals=4000, pool_size=64, mean_rate=2000.0)
    eng = FakeEngine(clock, **kw)
    win = loops.open_loop(eng, np.zeros((64, 4), np.float32), times, qidx, ["t"] * 4000,
                          keep=set(), answer_of=lambda r: r)
    from_submit = np.array([win["answer"][r] - eng.submitted[r] for r in range(4000)])
    return win, from_submit


def test_a_stall_moves_p95_from_due_time(monkeypatch):
    calm, calm_sub = _run(monkeypatch)
    stalled, stalled_sub = _run(monkeypatch, stall_at=200, stall=0.5)
    assert not np.isnan(stalled["answer"]).any()
    assert _p95(calm) < 10.0  # ms: a drain of 2 ms, arrivals every 0.5 ms
    # 0.5 s of stall at 2,000 a second: ~1,000 requests wait, a quarter of all
    assert _p95(stalled) > 100.0
    # timed from submission, the requests that fell due during the stall
    # look as if they had waited no longer than a queue of a few drains
    assert np.percentile(stalled_sub, 95) * 1e3 < _p95(stalled) / 2
    # every request due in the window is answered and counted
    assert np.isfinite(stalled["answer"]).all() and stalled["n_requests"] == 4000
