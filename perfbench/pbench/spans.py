"""What the program's own instrumentation says in a profiled stretch.

With tracing on (``repro_torch.obs.enable``, before the warm-up) the program
marks its host steps with ``repro_torch.*`` profiler spans, and the stages
of its query path with one-thread kernels named ``repro_torch_mark_<stage>``
(``route``, ``candidates``, ``verify``, ``rescore``, ``end``) inside its
graphs. :func:`summarize` reduces a chrome trace to three keys, beside those
of :func:`pbench.trace.summarize` on the same events:

- ``spans``: for each program span name starting inside the stretch, ``n``,
  ``host_s`` (the spans' time, cut at the stretch's end) and ``self_s``
  (``host_s`` less the time of the program spans nested in them);
- ``stages``: for each stage, ``n`` (its marks inside the stretch) and
  ``device_s``, the kernel, copy and set time on the mark's stream from
  each of its marks to the next mark on that stream (or the stretch's end);
- ``idle_by_span``: the device's idle seconds inside the stretch, under the
  innermost program span the host was in at the time, or ``none``.

A run whose program traces nothing gives ``spans`` and ``stages`` empty, and
all its idle time under ``none``.
"""
from __future__ import annotations

import re
from collections import defaultdict

from .trace import DEVICE_CATS, STRETCH, _union

SPAN = "repro_torch."
MARK = re.compile(r"repro_torch_mark_(\w+)")
NONE = "none"


def _interval(e: dict) -> tuple[float, float]:
    s = float(e["ts"])
    return s, s + float(e.get("dur", 0.0))


def summarize(events: list[dict]) -> dict:
    """``{"spans", "stages", "idle_by_span"}`` of the stretch (times in
    seconds); empty where the trace holds no stretch."""
    marks = [e for e in events
             if e.get("name") == STRETCH and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not marks:
        return {}
    w0, w1 = _interval(marks[0])
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN)]
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s0, t0 = _interval(e)
        s, t = max(s0, w0), min(t0, w1)
        if t > s or w0 <= s0 < w1:
            dev.append((s, max(s, t), e))
    return {"spans": _spans(spans, w0, w1), "stages": _stages(dev),
            "idle_by_span": _idle(spans, dev, w0, w1)}


def _spans(spans: list[dict], w0: float, w1: float) -> dict:
    out: dict[str, dict] = {}
    threads: dict = defaultdict(list)
    for e in spans:
        s, t = _interval(e)
        if w0 <= s < w1:
            threads[(e.get("pid"), e.get("tid"))].append((s, min(t, w1), e["name"]))

    def close(item, stack):
        s, t, name, nested = item
        rec = out.setdefault(name, {"n": 0, "host_s": 0.0, "self_s": 0.0})
        rec["n"] += 1
        rec["host_s"] += (t - s) * 1e-6
        rec["self_s"] += max(t - s - nested, 0.0) * 1e-6
        if stack:
            stack[-1][3] += min(t, stack[-1][1]) - s

    for items in threads.values():
        items.sort(key=lambda x: (x[0], -x[1]))
        stack: list[list] = []  # [start, end, name, time of nested spans]
        for s, t, name in items:
            while stack and stack[-1][1] <= s:
                close(stack.pop(), stack)
            stack.append([s, t, name, 0.0])
        while stack:
            close(stack.pop(), stack)
    return out


def _stages(dev: list[tuple]) -> dict:
    out: dict[str, dict] = {}
    streams: dict = defaultdict(list)
    for s, t, e in dev:
        streams[(e.get("pid"), e.get("tid"))].append((s, t, e))
    for items in streams.values():
        items.sort(key=lambda x: x[0])
        cur = None
        for s, t, e in items:
            m = MARK.search(e["name"]) if e.get("cat") == "kernel" else None
            if m is not None:
                cur = out.setdefault(m.group(1), {"n": 0, "device_s": 0.0})
                cur["n"] += 1
            if cur is not None:
                cur["device_s"] += (t - s) * 1e-6
    return out


def _innermost(spans: list[dict], w0: float, w1: float) -> list[tuple[float, float, str]]:
    """The host's innermost program span (the shortest one running, on any
    thread) over the stretch, as sorted ``(start, end, name)`` pieces."""
    edges = []
    for i, e in enumerate(spans):
        s, t = _interval(e)
        s, t = max(s, w0), min(t, w1)
        if t > s:
            edges += [(s, 1, i), (t, 0, i)]
    edges.sort()
    active: dict[int, tuple[float, str]] = {}
    out: list[tuple[float, float, str]] = []
    prev = None
    for x, opening, i in edges:
        if prev is not None and x > prev and active:
            name = min(active.values())[1]
            if out and out[-1][2] == name and out[-1][1] == prev:
                out[-1] = (out[-1][0], x, name)
            else:
                out.append((prev, x, name))
        if opening:
            s, t = _interval(spans[i])
            active[i] = (t - s, spans[i]["name"])
        else:
            active.pop(i, None)
        prev = x
    return out


def _idle(spans: list[dict], dev: list[tuple], w0: float, w1: float) -> dict:
    busy = _union([(s, t) for s, t, _ in dev if t > s])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    pieces = _innermost(spans, w0, w1)
    out: dict[str, float] = defaultdict(float)
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] += (hi - lo) * 1e-6
                covered += hi - lo
            k += 1
        if b - a - covered > 0:
            out[NONE] += (b - a - covered) * 1e-6
    return dict(out)
