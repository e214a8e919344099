"""A profiled stretch of a run's window, and what the per-layer readers take
from it.

The profiler is prepared during set-up (CUPTI's start-up is the slow part)
and records only between :meth:`Stretch.begin` and :meth:`Stretch.end`.
The harness marks the stretch and its own steps with ``record_function``
spans (``pbench.*``), so that the stretch's bounds and what the host was
doing in each idle gap of the device can be read from the trace.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STRETCH = "pbench.stretch"


class Stretch:
    """One profiled stretch: ``prepare()`` in set-up, ``begin()`` and
    ``end()`` around the traced work, then :meth:`summary`."""

    def __init__(self, device: torch.device):
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1 << 30))
        self.span = None
        self.events: list[dict] | None = None

    def prepare(self) -> None:
        self.prof.start()  # warm-up step: the profiler is ready, not recording

    def begin(self) -> None:
        self.prof.step()  # recording from here
        self.span = record_function(STRETCH)
        self.span.__enter__()

    def end(self) -> None:
        self.span.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)

    def summary(self) -> dict:
        return summarize(self.events or [])


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_labeller(host: list[dict]):
    """``t -> label``: the innermost harness span and the innermost host op
    running at ``t``."""
    ts = np.array([float(e["ts"]) for e in host])
    te = ts + np.array([float(e.get("dur", 0.0)) for e in host])
    names = [e["name"] for e in host]
    own = np.array([n.startswith("pbench.") and n != STRETCH for n in names], dtype=bool)
    ops = np.array([not n.startswith(("pbench.", "ProfilerStep")) for n in names], dtype=bool)

    def label(t: float) -> str:
        on = (ts <= t) & (t <= te)
        parts = []
        for kind in (own, ops):
            idx = np.nonzero(on & kind)[0]
            if idx.size:
                parts.append(names[idx[np.argmin(te[idx] - ts[idx])]])
        return " / ".join(parts) if parts else "host: no op"

    return label


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its return type and parameter list, cut to
    ``width`` characters: ``fused_verify_kernel<0, true, 32, false>``."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0 and ("<" in name or "::" in name):
            name = name[:i]
            break
    return name[:width]


def summarize(events: list[dict]) -> dict:
    """Reduce a chrome trace to the stretch's device activity.

    Returns ``window_s`` (the stretch's host time), ``busy_s`` (the union
    of device kernels, copies and sets inside it), ``kernels`` (name,
    seconds) of each kernel inside it, ``device_ops`` (the 10 names that
    took most device time) and ``idle_gaps`` (the 10 host activities under
    which the device stood idle longest, summed). Empty where the trace
    holds no stretch."""
    marks = [e for e in events
             if e.get("name") == STRETCH and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not marks:
        return {}
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    inside = []
    for e in dev:
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        s, t = max(s, w0), min(t, w1)
        if t > s:
            inside.append((s, t, e))
    busy = _union([(s, t) for s, t, _ in inside])
    by_name: dict[str, float] = defaultdict(float)
    kernels = []
    for s, t, e in inside:
        by_name[short_name(e["name"])] += (t - s) * 1e-6
        if e.get("cat") == "kernel":
            kernels.append((e["name"], (t - s) * 1e-6))
    gaps: dict[str, float] = defaultdict(float)
    label = _host_labeller(host)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[label((a + b) / 2)] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "kernels": kernels,
        "device_ops": top(by_name),
        "idle_gaps": top(gaps),
    }
