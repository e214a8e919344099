"""How the kernels' wrappers and the grid's collectives report their cost to
a counter (the dry run's ``launch/dryrun.py::StepCounter``).

A counter is any object with ``add(flops, nbytes)``, registered for the
block of :func:`counting`. The registry is the process's, not a thread's:
autograd runs a card's backward on a device thread of its own, and the
collectives of that backward report from there. :func:`hidden` is a
thread's: it marks code whose own ops the counter must not count, because a
report stands for them: a kernel wrapper's body (:class:`kernel`), whichever
branch it takes (the plain version, the launch, or the shape-only branch of
fake tensors), and a collective's staging. Outside a counter a report is a
no-op: no launch, no sync, nothing for a CUDA graph's capture to see.
"""
from __future__ import annotations

import contextlib
import threading

_COUNTERS: list = []  # registered counters, for every thread
_tls = threading.local()  # .hidden: this thread's depth of hidden code


def is_hidden() -> bool:
    """Whether this thread is inside :func:`hidden` code."""
    return getattr(_tls, "hidden", 0) > 0


@contextlib.contextmanager
def counting(counter):
    """``counter.add(flops, nbytes)`` receives every report made inside the
    block, on any thread of the process: count one step at a time."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


@contextlib.contextmanager
def hidden():
    """Inside the block (on this thread) a counter counts no op, a report
    stands for them, and no report reaches it: the outermost report stands
    for the nested."""
    _tls.hidden = getattr(_tls, "hidden", 0) + 1
    try:
        yield
    finally:
        _tls.hidden -= 1


def active() -> bool:
    """Whether a report made here would reach a counter."""
    return bool(_COUNTERS) and not is_hidden()


def report(flops: int, nbytes: int) -> None:
    """Add a cost to every registered counter (none: a no-op)."""
    if active():
        for c in list(_COUNTERS):
            c.add(flops, nbytes)


class kernel:
    """``with kernel(cost_of):`` around a kernel wrapper's body. Under a
    counter the body runs :func:`hidden` and ``cost_of()``, the call's
    ``(flops, bytes)`` from its arguments' shapes and dtypes, is reported
    once it returns; outside one, nothing is called."""

    __slots__ = ("cost_of", "cost")

    def __init__(self, cost_of):
        self.cost_of = cost_of
        self.cost = None

    def __enter__(self):
        if active():
            self.cost = self.cost_of()
            _tls.hidden = getattr(_tls, "hidden", 0) + 1

    def __exit__(self, exc_type, exc, tb):
        if self.cost is not None:
            _tls.hidden -= 1
            if exc_type is None:
                report(*self.cost)
        return False
