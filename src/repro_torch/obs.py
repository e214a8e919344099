"""Tracing inside the port: spans on the host and stage marks on the device,
both off until :func:`enable` is called.

- **Spans** (:func:`span`) are ``torch.profiler.record_function``
  annotations named ``repro_torch.<layer>.<step>``. They share the
  profiler's clock with its device trace, so any profiler running over the
  program records them; there is no exporter of their own. Off, or with
  no profiler recording, a span is one shared null context.
- **Stage marks** (:func:`mark`) launch an empty one-thread kernel
  (``kernels/csrc/marks.cu``, ``repro_torch_mark_<stage>``) on the current
  stream where a stage of the query path begins. Inside a capture they
  become nodes of the graph, so a profiled replay splits by stage: a stage's
  device time runs from its mark to the next mark on the same stream. Off,
  or on tensors that are not on the card, a mark launches nothing.

The switch is one flag for the process. A query-path graph keys on it
(``core.graphs``), so a graph captured without marks is never replayed with
tracing on, nor the reverse. ``mark.launches`` counts the marks launched
(a graph's at each replay, as every kernel wrapper counts).
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

from .device import is_fake
from .kernels.launch import I, P, bind, count, launch

# The query path's stages, in the order a device-tier search reaches them.
STAGES = ("route", "candidates", "verify", "rescore", "end")
MARK_PREFIX = "repro_torch_mark_"

_on = False
_NULL = contextlib.nullcontext()


def enable() -> None:
    """Turn tracing on, before the warm-up: a query-path signature already
    captured untraced is captured again, on the card, at its next call.
    Where there is a card the marks' library is built and loaded first, so
    that no capture loads it."""
    global _on
    if torch.cuda.is_available():
        err = bind("marks", "repro_torch_marks_load", [])()
        if err != 0:
            raise RuntimeError(f"loading the stage marks failed with CUDA error {err}")
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str):
    """A profiler span named ``name`` while tracing is on and a profiler is
    recording, else a null context: a span costs the host microseconds even
    where no profiler records it."""
    return record_function(name) if _on and torch.autograd._profiler_enabled() else _NULL


def mark(stage: str, like: torch.Tensor) -> None:
    """Launch the mark of ``stage`` on the current stream of ``like``'s
    device, while tracing is on and ``like`` holds values on the card."""
    if _on and _on_card(like):
        _launch(STAGES.index(stage), like.device)


mark.launches = 0


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda and not is_fake(t)


def _launch(stage: int, device: torch.device) -> None:
    fn = bind("marks", "repro_torch_mark_launch", [I, P])
    launch(f"{MARK_PREFIX}{STAGES[stage]}", fn, stage, device=device)
    count(mark, 1)
