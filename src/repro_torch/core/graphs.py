"""The query path's graph cache: the port's counterpart of ``jax.jit``'s
trace cache over the seven entries of ``core.lider`` (``_QUERY_PATH_GRAPHS``).

The JAX package compiles each query-path entry once per signature (the
shapes and dtypes of its arrays, its static options, the device) and then
dispatches one executable. Here an entry wrapped by :func:`query_path_entry`
keeps the signatures it has seen, and on the card one ``torch.cuda.CUDAGraph``
per signature:

- **On the CPU** there is no graph. The entry records the signature and runs
  its body, so ``core.lider.query_path_cache_size()`` counts as JAX's cache
  does on the CPU.
- **On the card** the first call of a signature runs the body (it builds and
  loads the kernels' libraries and grows the allocator) and then captures
  the body into a graph. Later calls copy the small inputs into the graph's
  static buffers, replay it, and hand back copies of its outputs, so an
  output is never overwritten by the graph's next replay. A capture that
  fails raises; nothing falls back to the eager body.

A graph bakes in the addresses of the tensors it reads. Its key therefore
holds, beside the signature, the address of every tensor it is bound to (the
index's leaves, and any input registered with :func:`persistent`) and the
caller's stream, so that two engines never replay one graph at once, and
whether tracing is on (``obs``: a graph captured with stage marks is never
replayed untraced, nor the reverse); neither adds a signature. A graph
dies with any tensor it is bound to (a weak reference), so a search on new
leaves of the same shapes (an update, ``set_rescore_tier``, a replica's
clone) captures anew and never reads a freed table; the signature stays
counted, as JAX's cache keeps a trace.

Each graph has its own memory pool (graphs of one engine are replayed in any
order, so none is shared); :func:`held_bytes` sums what the pools reserved.
Captures run one at a time, on a stream of their own, with
``capture_error_mode="thread_local"``, so a router's other threads may launch
meanwhile. The kernels' launch counters count a graph's launches at each
replay (``kernels.launch.count``), never at the capture.

An entry called while another entry runs (captured, replayed or eager) runs
its body and counts nothing, as a jitted function called inside a trace
does. ``entry.__wrapped__`` is the plain body, with every entry it reaches
plain too: the uncaptured search that a captured one is held against.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import inspect
import threading
import weakref
from typing import Any, Callable

import torch

from .. import obs
from ..device import is_fake
from ..kernels import launch

# Every wrapped entry, for held_bytes and release.
ENTRIES: list["QueryPathEntry"] = []

_depth = threading.local()  # entries running on this thread
_capture_lock = threading.Lock()  # one capture at a time in the process
_capture_streams: dict[int, torch.cuda.Stream] = {}
# id -> weak reference of each persistent buffer (a WeakSet would compare
# tensors with ``==``, which is elementwise).
_persistent: dict[int, weakref.ref] = {}


def _inside() -> bool:
    return getattr(_depth, "n", 0) > 0


@contextlib.contextmanager
def _running():
    _depth.n = getattr(_depth, "n", 0) + 1
    try:
        yield
    finally:
        _depth.n -= 1


def _base(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


def persistent(t: torch.Tensor) -> torch.Tensor:
    """Register ``t`` (a buffer its owner reuses from call to call) so that
    a graph given it as an input binds its address instead of copying it
    into a static buffer at each replay. Returns ``t``."""
    base = _base(t)
    key = id(base)
    _persistent[key] = weakref.ref(base, lambda _ref: _persistent.pop(key, None))
    return t


def _is_persistent(t: torch.Tensor) -> bool:
    base = _base(t)
    ref = _persistent.get(id(base))
    return ref is not None and ref() is base


# ---------------------------------------------------------------------------
# Trees of tensors: the arguments (dataclasses, named tuples, tuples) and
# the outputs (TopK, tuples) of the entries.
# ---------------------------------------------------------------------------


def _map(fn: Callable[[torch.Tensor], Any], obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: _map(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        )
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map(fn, v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(fn, v) for v in obj)
    return obj


def _map_key(fn: Callable[[torch.Tensor], Any], obj: Any) -> Any:
    """The key of a tree: ``fn`` of each tensor, the structure around them,
    and every other value as :func:`_hashable` sees it."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj),) + tuple(_map_key(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return (type(obj),) + tuple(_map_key(fn, v) for v in obj)
    return _hashable(obj)


def _leaves(obj: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map_key(out.append, obj)
    return out


_PLAIN = (int, float, str, bool, type(None), torch.dtype, torch.device)


def _hashable(obj: Any) -> Any:
    """A key's view of a static value: plain values as they are, any other
    object by its type and hash (an ``EmbStore`` hashes its tier, shape and
    dtype), so that a key never holds the object (a host table) alive."""
    if isinstance(obj, _PLAIN):
        return obj
    try:
        return (type(obj).__qualname__, hash(obj))
    except TypeError:
        return (type(obj).__qualname__, "id", id(obj))


def _shape(t: torch.Tensor) -> tuple:
    """What a signature sees of a tensor."""
    return ("tensor", tuple(t.shape), t.dtype)


def _traced(value: Any) -> Any:
    """A Python scalar that JAX passes as a traced argument: its trace
    depends on whether it is given and on its type, not on its value."""
    return None if value is None else ("scalar", type(value).__name__)


def _address(t: torch.Tensor) -> tuple:
    return ("at", t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, str(t.device))


# ---------------------------------------------------------------------------
# The graphs
# ---------------------------------------------------------------------------


class _Graph:
    """One captured graph: its static inputs (copied into at each call), its
    static outputs, the launches each replay makes, the bytes its memory
    pool reserved, and weak references to the tensors it is bound to."""

    def __init__(self, graph, static_inputs, static_out, launches, nbytes, bound, stream):
        self.graph = graph
        self.static_inputs = static_inputs
        self.static_out = static_out
        self.launches = launches
        self.nbytes = nbytes
        self.stream = stream
        self.bound_ids = {id(t) for t in bound}
        self.lock = threading.Lock()
        self.dead = False
        self.replays = 0
        # The callbacks hold the graph weakly: a cycle through them would
        # leave a dropped graph to the cyclic collector, which may run (and
        # destroy the graph) in the middle of another capture.
        die = functools.partial(_die, weakref.ref(self))
        self._refs = [weakref.ref(t, die) for t in bound]

    def replay(self, inputs: list[torch.Tensor]):
        with obs.span("repro_torch.graphs.replay"), self.lock:
            for static, t in zip(self.static_inputs, inputs):
                static.copy_(t, non_blocking=True)
            self.graph.replay()
            self.replays += 1
            launch.replayed(self.launches)
            return _map(torch.Tensor.clone, self.static_out)


_deaths: list[_Graph] = []


def _die(graph_ref, _tensor_ref) -> None:
    """A bound tensor was freed: the graph may read its memory no more. It
    is dropped at the next call of any entry (:func:`purge`)."""
    g = graph_ref()
    if g is not None:
        g.dead = True
        _deaths.append(g)


def purge() -> None:
    """Drop dead graphs, once the device has finished any replay of them."""
    if not _deaths:
        return
    with _capture_lock:
        dead = [g for g in _deaths if g.dead]
        _deaths.clear()
        if not dead:
            return
        torch.cuda.synchronize()
        for entry in ENTRIES:
            with entry.lock:
                entry.graphs = {k: g for k, g in entry.graphs.items() if not g.dead}


def live_graphs(stream=None) -> list[_Graph]:
    """The live graphs, all of them or those replayed on ``stream`` (an
    engine's). Each has ``nbytes`` (what its memory pool reserved when it
    was captured) and ``replays``."""
    key = None if stream is None else stream.cuda_stream
    out = []
    for entry in ENTRIES:
        with entry.lock:
            out += [g for g in entry.graphs.values()
                    if not g.dead and (key is None or g.stream == key)]
    return out


def held_bytes(stream=None) -> int:
    """Bytes the live graphs' memory pools hold (:func:`live_graphs`)."""
    return sum(g.nbytes for g in live_graphs(stream))


def release(stream, tensors) -> None:
    """Free the graphs replayed on ``stream`` that are bound to any of
    ``tensors`` (an engine's superseded leaves, which another replica may
    still hold alive)."""
    ids = {id(_base(t)) for t in tensors}
    key = stream.cuda_stream
    for entry in ENTRIES:
        with entry.lock:
            for g in entry.graphs.values():
                if g.stream == key and g.bound_ids & ids:
                    g.dead = True
                    _deaths.append(g)
    purge()


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    s = _capture_streams.get(device.index)
    if s is None:
        s = _capture_streams[device.index] = torch.cuda.Stream(device)
    return s


class QueryPathEntry:
    """A query-path entry: the body, its signatures and its graphs."""

    def __init__(self, fn: Callable, inputs: tuple[str, ...], traced: tuple[str, ...]):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._params = inspect.signature(fn)
        self.inputs = frozenset(inputs)
        self.traced = frozenset(traced)
        self.signatures: set = set()
        self.graphs: dict = {}
        self.lock = threading.Lock()

        @functools.wraps(fn)
        def plain(*args, **kw):
            with _running():
                return fn(*args, **kw)

        self.__wrapped__ = plain
        ENTRIES.append(self)

    def __repr__(self) -> str:
        return f"<query-path entry {self.__name__}: {len(self.signatures)} signatures>"

    def cache_size(self) -> int:
        """Distinct signatures seen, as ``jax.jit``'s ``_cache_size()``."""
        return len(self.signatures)

    def __call__(self, *args, **kw):
        if _inside():
            return self._fn(*args, **kw)
        bound = self._params.bind(*args, **kw)
        bound.apply_defaults()
        arguments = bound.arguments
        leaves = _leaves(list(arguments.values()))
        if not leaves or any(is_fake(t) for t in leaves):
            with _running():
                return self._fn(*args, **kw)
        held = [t for name, v in arguments.items() if name not in self.inputs for t in _leaves(v)]
        device = (held or leaves)[0].device
        sig = (str(device),) + tuple(
            (name, _traced(v) if name in self.traced else _map_key(_shape, v))
            for name, v in arguments.items()
        )
        with self.lock:
            new = sig not in self.signatures
            self.signatures.add(sig)
        if device.type != "cuda":
            with _running():
                return self._fn(*args, **kw)
        return self._cuda_call(arguments, device, new)

    def _graph_key(self, arguments: dict, stream) -> tuple[tuple, list, list]:
        """(key, tensors bound by address, inputs copied at each call)."""
        parts, bound, copied = [stream, obs.enabled()], [], []

        def bind(t):
            bound.append(_base(t))
            return _address(t)

        for name, v in arguments.items():
            if name in self.inputs:
                def inp(t):
                    if _is_persistent(t):
                        return bind(t)
                    copied.append(t)
                    return ("copy", tuple(t.shape), t.dtype)
                parts.append((name, _map_key(inp, v)))
            elif name in self.traced:
                parts.append((name, v))
            else:
                parts.append((name, _map_key(bind, v)))
        return tuple(parts), bound, copied

    def _cuda_call(self, arguments: dict, device: torch.device, new: bool):
        purge()
        stream = torch.cuda.current_stream(device).cuda_stream
        key, bound, copied = self._graph_key(arguments, stream)
        with self.lock:
            g = self.graphs.get(key)
        if g is not None and not g.dead:
            return g.replay(copied)
        out = None
        if new:
            # The first call of a signature runs eagerly: the libraries
            # build and load, the allocator grows, and its answer is the
            # call's answer.
            with _running():
                out = self._fn(**arguments)
        g = self._capture(arguments, device, stream, bound, copied)
        with self.lock:
            self.graphs[key] = g
        return out if new else g.replay(copied)

    def _capture(self, arguments, device, stream, bound, copied) -> _Graph:
        statics = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in copied]
        for s, t in zip(statics, copied):
            s.copy_(t)
        it = iter(statics)
        cap_args = {}
        for name, v in arguments.items():
            if name in self.inputs:
                cap_args[name] = _map(lambda t: t if _is_persistent(t) else next(it), v)
            else:
                cap_args[name] = v
        graph = torch.cuda.CUDAGraph()
        gc_was_on = gc.isenabled()
        with _capture_lock, torch.cuda.device(device):
            # No collection while capturing: destroying a graph (or anything
            # else that calls into CUDA) on this thread would invalidate it.
            gc.disable()
            try:
                with launch.captured_launches() as launches:
                    with torch.cuda.graph(graph, stream=_capture_stream(device),
                                          capture_error_mode="thread_local"):
                        before = torch.cuda.memory_reserved(device)
                        with _running():
                            static_out = self._fn(**cap_args)
            except Exception as e:
                raise RuntimeError(
                    f"capturing {self.__name__} into a CUDA graph failed: {e}"
                ) from e
            finally:
                if gc_was_on:
                    gc.enable()
            nbytes = torch.cuda.memory_reserved(device) - before
        return _Graph(graph, statics, static_out, list(launches), max(nbytes, 0), bound, stream)



def query_path_entry(*, inputs: tuple[str, ...] = (), traced: tuple[str, ...] = ()):
    """Wrap a query-path entry in the graph cache.

    ``inputs`` name the arguments that change from call to call (the
    queries, the schedule arrays, the provisional rows, the fetched rows):
    their values are copied into the graph's static buffers at each call,
    unless a tensor is :func:`persistent`, which binds its address. Every
    other tensor argument (the index's leaves) is bound by address.
    ``traced`` name the Python scalars that JAX traces rather than keys on
    (``prune_margin``): a graph keys on their value, the signature count on
    whether they are given."""
    return lambda fn: QueryPathEntry(fn, inputs, traced)
