"""The port's tracing switch (``repro_torch.obs``), on the CPU.

Off, a search and an engine drain record no ``repro_torch.*`` span and
launch no stage mark. On, the engine's steps are spans, in order, nested in
the caller's span and holding the search's ops; the marks open the query
path's stages in order; a query-path graph keys on the switch, which adds
no signature; a graph's replay is a span. The engine's queue counter is
exact under a controlled clock.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.core import graphs, lider
from repro_torch.data import synthetic
from repro_torch.serving import RetrievalEngine, SchedulerConfig, make_backend
from repro_torch.serving import engine as engine_mod

N, D, K = 2000, 32, 10
CFG = lider.LiderConfig(n_clusters=16, n_probe=4, n_arrays=4, n_leaves=4, kmeans_iters=4)
STEPS = ("take", "stage", "search", "wait", "record")


@pytest.fixture(scope="module")
def data():
    x = synthetic.retrieval_corpus(0, N, D, device="cpu")
    q, _ = synthetic.retrieval_queries(1, x, 24)
    return x, q


@pytest.fixture(scope="module")
def index(data):
    return lider.build_lider(0, data[0], CFG, device="cpu")


@pytest.fixture
def tracing():
    obs.enable()
    try:
        yield
    finally:
        obs.disable()


@pytest.fixture
def marks(monkeypatch):
    """The stages whose marks launch, with every tensor taken as on the card."""
    seen = []
    monkeypatch.setattr(obs, "_on_card", lambda t: True)
    monkeypatch.setattr(obs, "_launch", lambda stage, device: seen.append(obs.STAGES[stage]))
    return seen


def _engine(index, batch_size=8, **kw):
    return RetrievalEngine(make_backend("lider", index, n_probe=4, r0=4), batch_size=batch_size,
                           k=K, dim=D, **kw)


def _profiled_drain(eng, q):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for v in np.asarray(q):
            eng.submit(v)
        with record_function("test.drain"):
            eng.drain()
    return [e for e in prof.events()]


def test_tracing_off_records_no_span_and_launches_no_mark(data, index, marks):
    assert not obs.enabled()
    events = _profiled_drain(_engine(index), data[1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lider.search_lider(index, data[1], k=K, n_probe=4)
    names = {e.name for e in events + list(prof.events())}
    assert "test.drain" in names
    assert not [n for n in names if n.startswith("repro_torch.")]
    assert marks == []


def test_tracing_on_spans_the_engine_steps_in_order(data, index, tracing):
    events = _profiled_drain(_engine(index), data[1])
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    assert len(by_name["repro_torch.engine.submit"]) == 24
    (drain,) = by_name["test.drain"]
    steps = [sorted(by_name[f"repro_torch.engine.{s}"], key=lambda e: e.time_range.start)
             for s in STEPS]
    assert [len(s) for s in steps] == [3] * len(STEPS)  # 24 queries in batches of 8
    for batch in zip(*steps):
        starts = [e.time_range.start for e in batch]
        assert starts == sorted(starts)
        for a, b in zip(batch, batch[1:]):
            assert a.time_range.end <= b.time_range.start  # siblings, not nested
        for e in batch:
            assert drain.time_range.start <= e.time_range.start
            assert e.time_range.end <= drain.time_range.end
    ops = [e for e in by_name if e.startswith("aten::")]
    inside = lambda span, e: (span.time_range.start <= e.time_range.start
                              and e.time_range.end <= span.time_range.end)
    for span in steps[STEPS.index("search")]:
        assert any(inside(span, e) for name in ops for e in by_name[name])


@pytest.mark.parametrize("storage, want", [
    ("float32", ["route", "candidates", "verify", "end"]),
    ("int8", ["route", "candidates", "verify", "rescore", "end"]),
])
def test_marks_open_each_stage_in_order(data, index, marks, tracing, storage, want):
    params = index if storage == "float32" else lider.build_lider(
        0, data[0], dataclasses.replace(CFG, storage_dtype=storage), device="cpu")
    lider.search_lider(params, data[1][:4], k=K, n_probe=4)
    assert marks == want


def test_graph_key_holds_the_switch(data, index):
    entry = lider._search_lider_device
    args = entry._params.bind(index, data[1][:4], k=K, n_probe=4)
    args.apply_defaults()
    off = entry._graph_key(args.arguments, 0)
    lider.search_lider(index, data[1][:4], k=K, n_probe=4)
    before = lider.query_path_cache_size()
    obs.enable()
    try:
        on = entry._graph_key(args.arguments, 0)
        assert on[0] == entry._graph_key(args.arguments, 0)[0]
        lider.search_lider(index, data[1][:4], k=K, n_probe=4)
    finally:
        obs.disable()
    assert off[0] != on[0]
    assert [id(t) for t in off[1]] == [id(t) for t in on[1]]  # the same tensors bound
    assert [id(t) for t in off[2]] == [id(t) for t in on[2]]  # and copied
    assert off[0] == entry._graph_key(args.arguments, 0)[0]
    assert lider.query_path_cache_size() == before  # the switch adds no signature


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_replay_is_a_span_only_while_tracing(on):
    replays = []
    fake = types.SimpleNamespace(replay=lambda: replays.append(1))
    static = torch.zeros(3)
    g = graphs._Graph(fake, [static], (static * 2,), [], 0, [], 0)
    if on:
        obs.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = g.replay([torch.ones(3)])
    finally:
        obs.disable()
    assert replays == [1] and torch.equal(static, torch.ones(3)) and out[0] is not g.static_out[0]
    spans = [e for e in prof.events() if e.name == "repro_torch.graphs.replay"]
    assert len(spans) == int(on)


def test_queue_wait_is_exact_under_a_controlled_clock(data, index, monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(engine_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0], sleep=lambda s: None))
    eng = _engine(index, batch_size=4, scheduler=SchedulerConfig(cache_size=16))
    q = np.asarray(data[1])
    for i in range(5):
        clock[0] = 1.0 + i
        eng.submit(q[i])
    clock[0] = 10.0
    eng.drain(max_dispatches=1)
    assert (eng.stats.queue_wait_s, eng.stats.n_queue_waits) == (9 + 8 + 7 + 6, 4)
    clock[0] = 20.0
    eng.drain()
    assert (eng.stats.queue_wait_s, eng.stats.n_queue_waits) == (30 + 15, 5)
    clock[0] = 21.0
    eng.submit(q[0])  # answered from the cache: no queue wait
    clock[0] = 30.0
    eng.drain()
    assert eng.stats.n_cache_hits == 1
    assert (eng.stats.queue_wait_s, eng.stats.n_queue_waits) == (45, 5)


def test_spans_wait_for_a_profiler(tracing):
    assert obs.span("repro_torch.engine.submit") is obs._NULL  # no profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(obs.span("repro_torch.engine.submit"), record_function)
