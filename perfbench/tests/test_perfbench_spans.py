"""``pbench.spans.summarize`` on a chrome trace made by hand: two marked
batches on one stream, a copy on another stream, nested program spans and
idle gaps, each key counted by hand; and ``pbench.trace.summarize`` on the
same events, whose idle time the new key splits."""
import pytest

from pbench import spans, trace


def _x(name, cat, ts, end, pid, tid):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts, "pid": pid, "tid": tid}


def host(name, ts, end, cat="user_annotation"):
    return _x(name, cat, ts, end, 1, 1)


def dev(name, ts, end, cat="kernel", tid=7):
    return _x(name, cat, ts, end, 0, tid)


def mark(stage, ts):
    return dev(f"repro_torch_mark_{stage}", ts, ts + 1)


E = "repro_torch.engine."
REPLAY = "repro_torch.graphs.replay"

EVENTS = [
    host(trace.STRETCH, 1000, 2000),
    host(E + "submit", 900, 950),  # before the stretch
    host(E + "submit", 1000, 1020),
    host("pbench.drain", 1040, 1560),  # the harness's, not the program's
    host(E + "take", 1050, 1060),
    host(E + "stage", 1060, 1100),
    host("aten::copy_", 1070, 1090, cat="cpu_op"),
    host(E + "search", 1100, 1200), host(REPLAY, 1110, 1190),
    host(E + "wait", 1200, 1500),
    host(E + "record", 1500, 1550),
    host(E + "search", 1600, 1700), host(REPLAY, 1610, 1680),
    host(E + "wait", 1700, 2100),  # cut at the stretch's end
    dev("before_the_stretch", 950, 1010),  # no mark before it: no stage
    dev("Memcpy HtoD", 1090, 1095, cat="gpu_memcpy"),  # the first copy-in, before any mark
    mark("route", 1120), dev("route_kernel", 1121, 1140),
    mark("candidates", 1140), dev("gather", 1141, 1180),
    mark("verify", 1180), dev("fused_verify_kernel<0>", 1181, 1450),
    mark("end", 1450), dev("Memcpy DtoD", 1451, 1460, cat="gpu_memcpy"),
    dev("Memcpy DtoH", 1460, 1480, cat="gpu_memcpy", tid=9),  # another stream: no stage
    dev("Memcpy DtoD", 1620, 1625, cat="gpu_memcpy"),  # the next copy-in, after the end mark
    mark("route", 1630), dev("route_kernel", 1631, 1650),
    mark("candidates", 1650), dev("gather", 1651, 1700),
    mark("verify", 1700), dev("fused_verify_kernel<2>", 1701, 1900),
    mark("rescore", 1900), dev("fused_verify_kernel<0>", 1901, 1950),
    mark("end", 1950), dev("Memcpy DtoD", 1951, 1960, cat="gpu_memcpy"),
]

US = 1e-6


def test_program_keys_as_counted_by_hand():
    out = spans.summarize(EVENTS)
    assert set(out) == {"spans", "stages", "idle_by_span"}
    assert out["stages"] == {
        "route": {"n": 2, "device_s": pytest.approx(40 * US)},
        "candidates": {"n": 2, "device_s": pytest.approx(90 * US)},
        "verify": {"n": 2, "device_s": pytest.approx(470 * US)},
        "rescore": {"n": 1, "device_s": pytest.approx(50 * US)},
        "end": {"n": 2, "device_s": pytest.approx(25 * US)},
    }
    want_spans = {  # n, host, self (us)
        E + "submit": (1, 20, 20), E + "take": (1, 10, 10), E + "stage": (1, 40, 40),
        E + "search": (2, 200, 50), REPLAY: (2, 150, 150), E + "wait": (2, 600, 600),
        E + "record": (1, 50, 50),
    }
    assert out["spans"] == {
        name: {"n": n, "host_s": pytest.approx(h * US), "self_s": pytest.approx(s * US)}
        for name, (n, h, s) in want_spans.items()}
    want_idle = {E + "submit": 10, "none": 80, E + "take": 10, E + "stage": 35, E + "search": 20,
                 REPLAY: 25, E + "wait": 60, E + "record": 50}
    assert out["idle_by_span"] == {k: pytest.approx(v * US) for k, v in want_idle.items()}


def test_harness_summary_of_the_same_events():
    out = trace.summarize(EVENTS)
    assert out["window_s"] == pytest.approx(1000 * US)
    assert out["busy_s"] == pytest.approx(710 * US)
    idle = sum(spans.summarize(EVENTS)["idle_by_span"].values())
    assert idle == pytest.approx(out["window_s"] - out["busy_s"])
    assert sum(v for _, v in out["idle_gaps"]) == pytest.approx(idle)


def test_untraced_program_gives_empty_keys():
    plain = [e for e in EVENTS if not e["name"].startswith("repro_torch")]
    out, whole = spans.summarize(plain), trace.summarize(plain)
    assert out["spans"] == {} and out["stages"] == {}
    assert out["idle_by_span"] == {"none": pytest.approx(whole["window_s"] - whole["busy_s"])}
    assert spans.summarize([]) == {}
