"""What every kernel wrapper shares: binding a symbol of a built library
with ``ctypes``, checking a tensor argument, refusing CPU tensors, laying
out rows for a TMA tensor map, launching on the current stream with the
launch's error raised, and counting launches.

A router launches from several threads at once, so binding and counting
take a lock: a counter's ``+=`` is a read and a write, and two threads
could lose a count between them.

A wrapper called while a CUDA graph is being captured launches nothing:
the graph launches its kernels at each replay. So a count made during a
capture is held for the graph (:func:`captured_launches`) and added at each
of its replays (:func:`replayed`), never at the capture."""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from . import build

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong


_bound: dict = {}
_lock = threading.Lock()
_capturing = threading.local()  # .held: the counts of the graph being captured here


def bind(library: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function ``symbol`` of ``library``, its argument and return
    types declared once (a short launch's time is mostly the host's)."""
    fn = _bound.get((library, symbol))
    if fn is None:
        with _lock:
            fn = _bound.get((library, symbol))
            if fn is None:
                fn = getattr(build.load_library(library), symbol)
                fn.argtypes = argtypes
                fn.restype = restype
                _bound[(library, symbol)] = fn
    return fn


def count(wrapper, n: int) -> None:
    """Add ``n`` launches to ``wrapper.launches``, under the lock; during a
    capture on this thread, hold them for the graph's replays instead."""
    held = getattr(_capturing, "held", None)
    if held is not None:
        held.append((wrapper, n))
        return
    with _lock:
        wrapper.launches += n


@contextlib.contextmanager
def captured_launches():
    """The ``(wrapper, n)`` counts made on this thread inside the block (a
    graph's capture), which leave the counters as they are."""
    held: list = []
    _capturing.held = held
    try:
        yield held
    finally:
        _capturing.held = None


def replayed(launches) -> None:
    """Count the launches of one replay of a graph (its captured counts)."""
    with _lock:
        for wrapper, n in launches:
            wrapper.launches += n


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cuda(name: str, t: torch.Tensor, plain: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(
            f"{name} runs on CUDA tensors, got {t.device}; the plain version is "
            f"ref.{plain}"
        )
    return t.device


def tma_rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A (rows, cols) tensor as a TMA tensor map reads it: 16-byte aligned
    rows a multiple of 16 bytes apart. Any other tensor is copied into a
    zero-padded buffer. Returns the tensor and its row pitch in elements."""
    per16 = 16 // t.element_size()
    cols = t.shape[1]
    if cols % per16 == 0 and t.data_ptr() % 16 == 0:
        return t, cols
    ld = -(-cols // per16) * per16
    return (torch.nn.functional.pad(t, (0, ld - cols)) if ld > cols else t.clone()), ld


def launch(name: str, fn, *args, device) -> None:
    """Call a C entry point with the current stream as its last argument;
    it returns the ``cudaError_t`` of the launch, raised here if not 0."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
